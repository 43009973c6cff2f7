"""Plain mini-batch kernel k-means for the RBF kernel (paper Alg.1, Eq.4-8,
Eq.12), in float64, used to judge the program's fits.

With K = exp(-gamma |x - y|^2) every quantity of the algorithm is a sum of
terms near 1 whose signal is the small remainder E = 1 - K (at the
paper's sigma = 4 d_max, E is 1e-5..1e-2). The reference therefore keeps E
itself, ``-expm1(-gamma d^2)`` with d^2 from float64 products, and writes
each step in E:

    f_ij = 1 - fE_ij,   fE_ij = sum_{m in j} E_im / n_j             (Eq.6)
    g_j  = 1 - gE_j,    gE_j  = sum_{l in j} fE_lj / n_j            (Eq.5)
    K_ii + g_j - 2 f_ij = 2 fE_ij - gE_j                            (Eq.4)
    Eq.7 medoid:  argmin_l fE_lj
    Eq.8 init:    argmin_j E(x_i, m_j)
    Eq.12 merge:  argmin_l (1 - a_j) E(x_l, m_j) + a_j E(x_l, m_j^i)

so no sum cancels. E is the batch's rows against its landmarks L (the
sums over members run over the cluster's landmarks; at s = 1 on one
process every batch row is a landmark, on a mesh |L| is rounded to a
multiple of its row count: ``draws.n_landmarks``). It is held as float32
(its relative precision carries the signal) and contracted in float64 row
blocks, as many kept as fit in the device's free memory with room to
spare (all where [n, |L|] float32 fits), the others worked out again by
every contraction. ``tf32=True`` rounds every product's operands to
TF32 (a 10-bit mantissa, as the tensor cores read float32 with TF32 on):
the control, the reference computed in the nearest precision below the
configuration's float32."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import draws

BIG = 1e30
BLOCK = 4096


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10-bit mantissa."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def rbf_e(a: torch.Tensor, b: torch.Tensor, gamma: float, *,
          tf32: bool = False) -> torch.Tensor:
    """E = 1 - K(a, b) [len(a), len(b)] in float64."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    if tf32:
        dot = (round_tf32(a).to(torch.float64)
               @ round_tf32(b).to(torch.float64).T)
    else:
        dot = a64 @ b64.T
    d2 = (a64 * a64).sum(1)[:, None] + (b64 * b64).sum(1)[None, :] - 2.0 * dot
    e = -torch.expm1(-gamma * d2.clamp(min=0.0))
    if tf32:            # K itself enters the matvec in TF32
        e = 1.0 - round_tf32(1.0 - e).to(torch.float64)
    return e


def room(x: torch.Tensor, block: int, m: int) -> float:
    """Bytes E may take on ``x``'s device: its free memory (the caching
    allocator's unused blocks counted free) less what one row block's
    build and contraction hold at once, six [block, m] float64 tensors,
    and 2 GiB; unbounded off the card."""
    if x.device.type != "cuda":
        return math.inf
    free, _ = torch.cuda.mem_get_info(x.device)
    free += (torch.cuda.memory_reserved(x.device)
             - torch.cuda.memory_allocated(x.device))
    return free - 6.0 * 8.0 * block * m - 2.0 ** 31


class Gram:
    """E of a batch against its landmarks ``cols`` (all rows where None)
    [n, |L|], float32, in row blocks of ``block`` rows. The first blocks
    that fit in the ``room`` on the device are kept (all of them where E
    fits); every ``apply`` builds the others again by the same calls, so
    the numbers do not depend on how many are kept."""

    def __init__(self, x: torch.Tensor, gamma: float, *, tf32: bool = False,
                 block: int = BLOCK, cols: Optional[torch.Tensor] = None):
        self.block, self.cols = block, cols
        self.x, self.gamma, self.tf32 = x, gamma, tf32
        self.y = x if cols is None else x[cols.to(x.device)]
        m = self.y.shape[0]
        n_blocks = -(-x.shape[0] // block)
        fit = room(x, block, m) / (4.0 * block * m)
        keep = n_blocks if fit >= n_blocks else max(int(fit), 0)
        self.kept = [self._rows(j * block) for j in range(keep)]

    def _rows(self, s: int) -> torch.Tensor:
        return rbf_e(self.x[s:s + self.block], self.y, self.gamma,
                     tf32=self.tf32).to(torch.float32)

    def apply(self, h: torch.Tensor) -> torch.Tensor:
        """E @ h [n, C] float64."""
        h = h.to(torch.float64)
        out = []
        for j, s in enumerate(range(0, self.x.shape[0], self.block)):
            blk = self.kept[j] if j < len(self.kept) else self._rows(s)
            out.append(blk.to(torch.float64) @ h)
        return torch.cat(out)


class Stats(NamedTuple):
    fe: torch.Tensor       # [n, C] fE
    ge: torch.Tensor       # [C] gE
    counts: torch.Tensor   # [C] float64


def stats(gram: Gram, labels: torch.Tensor, c: int) -> Stats:
    """Eq.5-6 in E at ``labels`` [n]: the sums over a cluster's landmarks
    (``gram.cols``), counts of its landmarks."""
    lab = labels if gram.cols is None else labels[gram.cols.to(labels.device)]
    h = torch.nn.functional.one_hot(lab.long(), c).to(torch.float64)
    counts = h.sum(0)
    safe = counts.clamp(min=1.0)
    fe = gram.apply(h) / safe[None, :]
    fl = fe if gram.cols is None else fe[gram.cols.to(fe.device)]
    ge = (h * fl).sum(0) / safe
    return Stats(fe, ge, counts)


def scores(st: Stats) -> torch.Tensor:
    """K_ii + g_j - 2 f_ij [n, C]; empty clusters unjoinable."""
    d = 2.0 * st.fe - st.ge[None, :]
    return torch.where(st.counts[None, :] > 0, d, torch.full_like(d, BIG))


class Inner(NamedTuple):
    labels: torch.Tensor
    st: Stats              # at the final labels
    n_iter: int
    cost: float            # sum of each row's minimum, last sweep
    row_cost: torch.Tensor  # [n] that minimum


def inner(gram: Gram, labels0: torch.Tensor, c: int,
          max_iters: int) -> Inner:
    """Eq.4 to its label fixpoint (or ``max_iters`` sweeps). At the
    fixpoint the last sweep's stats are those of the final labels."""
    labels = labels0.long()
    t, changed, st = 0, True, None
    mind = torch.full((labels.shape[0],), math.inf, dtype=torch.float64,
                      device=labels.device)
    while changed and t < max_iters:
        st = stats(gram, labels, c)
        d = scores(st)
        new = torch.argmin(d, dim=1)
        mind = d.gather(1, new[:, None])[:, 0]
        changed = bool((new != labels).any())
        labels, t = new, t + 1
    if changed or st is None:
        st = stats(gram, labels, c)
    return Inner(labels, st, t, float(mind.sum()), mind)


def kpp_seeds(x: torch.Tensor, gamma: float, c: int, gen: torch.Generator,
              *, tf32: bool = False) -> torch.Tensor:
    """Greedy kernel k-means++ with the draws of ``gen``: the first seed
    uniform, then 2 + floor(ln C) candidates a step by the inverse D^2 CDF
    (float64 cumulative sum, uniform numbers in float64), keeping the one
    with the least potential."""
    n, dev = x.shape[0], x.device
    n_cand = 2 + int(math.log(max(c, 1)))
    chosen = [int(torch.randint(n, (1,), generator=gen))]
    mind2 = torch.full((n,), math.inf, dtype=torch.float64, device=dev)
    for _ in range(c - 1):
        d2 = 2.0 * rbf_e(x, x[chosen[-1]][None], gamma, tf32=tf32)[:, 0]
        mind2 = torch.minimum(mind2, d2)
        w = mind2 if bool((mind2 > 0).any()) else torch.ones_like(mind2)
        cdf = torch.cumsum(w, dim=0)
        u = torch.rand(n_cand, generator=gen, dtype=torch.float64).to(dev)
        cands = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp(
            max=n - 1)
        d2c = 2.0 * rbf_e(x, x[cands], gamma, tf32=tf32)
        pot = torch.minimum(mind2[:, None], d2c).sum(0)
        chosen.append(int(cands[torch.argmin(pot)]))
    return torch.tensor(chosen, device=dev)


class Step(NamedTuple):
    """One batch of the reference from a given entering state."""
    inner: Inner
    medoids: torch.Tensor            # [C, d] the state after the batch
    cardinalities: torch.Tensor      # [C] float64
    batch_medoids: torch.Tensor      # [C, d] Eq.7's rows
    alpha: Optional[torch.Tensor]    # [C] Eq.12's weights (None at i = 0)
    score: torch.Tensor              # [n, C] what the medoids minimize
    cols: Optional[torch.Tensor] = None   # the landmarks (None: all rows)


def batch_step(x: torch.Tensor, gamma: float, c: int, max_iters: int, *,
               seed: int, i: int, medoids_in: Optional[torch.Tensor] = None,
               card_in: Optional[torch.Tensor] = None,
               tf32: bool = False, s: float = 1.0,
               multiple_of: int = 1) -> Step:
    """Batch ``i`` of a fit with seed ``seed``: the landmarks (|L| at
    ``s`` rounded to ``multiple_of``), k-means++ seeds among them (i = 0)
    or Eq.8 from ``medoids_in``, the inner loop, Eq.7, and Eq.12 against
    ``medoids_in`` / ``card_in``."""
    gen = draws.batch_generator(seed, i)
    n = x.shape[0]
    cols = draws.landmarks(gen, n, draws.n_landmarks(n, s, c, multiple_of))
    gram = Gram(x, gamma, tf32=tf32, cols=cols)
    if medoids_in is None:
        xl = gram.y
        start = xl[kpp_seeds(xl, gamma, c, gen, tf32=tf32)]
    else:
        start = medoids_in
    labels0 = torch.argmin(rbf_e(x, start, gamma, tf32=tf32), dim=1)
    res = inner(gram, labels0, c, max_iters)
    del gram
    mb = torch.argmin(res.st.fe, dim=0)
    if medoids_in is None:
        return Step(res, x[mb], res.st.counts, x[mb], None, res.st.fe, cols)
    card_in = card_in.to(torch.float64)
    alpha = res.st.counts / (res.st.counts + card_in).clamp(min=1.0)
    s12 = ((1.0 - alpha)[None, :] * rbf_e(x, medoids_in, gamma, tf32=tf32)
           + alpha[None, :] * rbf_e(x, x[mb], gamma, tf32=tf32))
    merged = x[torch.argmin(s12, dim=0)]
    keep = res.st.counts == 0
    medoids = torch.where(keep[:, None], medoids_in.to(x.dtype), merged)
    return Step(res, medoids, card_in + res.st.counts, x[mb], alpha, s12,
                cols)


def _score_at(step: Step, m: torch.Tensor, x: torch.Tensor, gamma: float,
              medoids_in: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's own medoid score of cluster j at the point m_j
    [C]: Eq.7's fE (the mean E to the cluster's landmarks) at batch 0,
    Eq.12's merge score after."""
    if medoids_in is None:
        labels, xl = step.inner.labels, x
        if step.cols is not None:
            cols = step.cols.to(x.device)
            labels, xl = labels[cols], x[cols]
        h = torch.nn.functional.one_hot(labels, m.shape[0]).to(
            torch.float64)
        return ((rbf_e(m, xl, gamma) * h.T).sum(1)
                / step.inner.st.counts.clamp(min=1.0))
    a = step.alpha
    return ((1.0 - a) * rbf_e(m, medoids_in, gamma).diagonal()
            + a * rbf_e(m, step.batch_medoids, gamma).diagonal())


def medoid_gap(step: Step, m: torch.Tensor, x: torch.Tensor, gamma: float,
               medoids_in: Optional[torch.Tensor]) -> float:
    """How much worse than the reference's best the medoids ``m`` [C, d]
    are by the reference's own Eq.7 / Eq.12 score: for each cluster the
    batch filled, the excess of the score at m_j over the least score of
    any batch row, over the score's spread (the median over the
    cluster's members, or over every row where that is the least, less
    that least score); the worst cluster. Medoids tied to rounding
    read near 0, a wrong choice or a wrong merge order 1."""
    at = _score_at(step, m.to(x.device), x, gamma, medoids_in)
    worst = 0.0
    for j in range(m.shape[0]):
        if step.inner.st.counts[j] == 0:
            continue        # kept: the ``medoid`` number's to judge
        col = step.score[:, j]
        low = col.min()
        spread = float(col[step.inner.labels == j].median() - low)
        if spread <= 0.0:
            spread = float(col.median() - low)
        excess = max(float(at[j] - low), 0.0)
        if excess > 0.0:
            worst = max(worst, excess / spread if spread > 0.0 else math.inf)
    return worst


def _is_row(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[C] True where a medoid equals some row of ``x``, bit for bit."""
    return torch.stack([(x == r).all(dim=1).any() for r in m])


def judge_batch(x: torch.Tensor, gamma: float, c: int, max_iters: int, *,
                seed: int, i: int, cost: float, counts, state_out,
                state_in=None, s: float = 1.0,
                multiple_of: int = 1) -> dict:
    """The reference's batch ``i`` from the program's entering state
    ``state_in`` (medoids, cardinalities; None at batch 0), and the
    program's outputs for it (its cost and cluster counts, its state
    after the batch) judged against it -> compared numbers:

    cost    |program's cost - reference's| / reference's (Eq.9 at the
            inner fixpoint)
    count   the program's bookkeeping against the batch: |sum_j n_j -
            |L|| / |L| plus sum_j |W_j - W_j^in - n_j| / |L| (n_j the
            batch's landmark counts it reports, W the cardinalities
            entering and leaving)
    medoid  share of clusters whose medoid after the batch is neither a
            row of the batch nor, for a cluster the batch left empty, the
            medoid it had
    medoid_gap  the program's medoids after the batch by the reference's
            Eq.7 (batch 0) or Eq.12 score (``medoid_gap``): a medoid
            picked by a wrong rule, or merged with the wrong weights,
            reads order 1

    and, not compared, ``moved``: share of the batch's rows the program's
    cardinalities put elsewhere than the reference's, sum_j |W_j -
    W_j^ref| / 2|L|. Rows whose two nearest clusters tie to float32
    rounding may land on either side, and on a fit whose seeding split a
    class the two fixpoints then part by thousands of rows; so the
    partition and the medoids' ranks among near-equal rows are not
    compared, only what they sum to and how far the medoids' scores lie
    from the best."""
    medoids_in = None if state_in is None else state_in.medoids.to(x.device)
    card_in = None if state_in is None else \
        state_in.cardinalities.to(x.device).to(torch.float64)
    ref = batch_step(x, gamma, c, max_iters, seed=seed, i=i,
                     medoids_in=medoids_in, card_in=card_in, s=s,
                     multiple_of=multiple_of)
    n = x.shape[0] if ref.cols is None else ref.cols.shape[0]
    cnt = torch.as_tensor(counts, dtype=torch.float64, device=x.device)
    card_out = state_out.cardinalities.to(x.device).to(torch.float64)
    w_in = card_in if card_in is not None else torch.zeros_like(card_out)
    count = (abs(float(cnt.sum()) - n)
             + float((card_out - w_in - cnt).abs().sum())) / n
    out = state_out.medoids.to(x.device)
    ok = _is_row(out, x)
    if medoids_in is not None:
        ok |= (cnt == 0) & (out == medoids_in).all(dim=1)
    return {"cost": abs(cost - ref.inner.cost) / abs(ref.inner.cost),
            "count": count, "medoid": float((~ok).sum()) / c,
            "medoid_gap": medoid_gap(ref, out, x, gamma, medoids_in),
            "moved": float((card_out - ref.cardinalities).abs().sum())
            / (2.0 * n)}


def predict_gap(x: torch.Tensor, medoids: torch.Tensor, labels,
                gamma: float) -> float:
    """The worst held-out row's excess squared feature-space distance to
    the medoid the program labelled it with, over its nearest, divided by
    the median row's distance to its nearest medoid."""
    e = rbf_e(x, medoids.to(x.device), gamma)
    best = e.min(dim=1).values
    at = e.gather(1, torch.as_tensor(labels, device=x.device).long()[:, None])
    return float((at[:, 0] - best).max()) / float(torch.median(best))


def fit(x: torch.Tensor, gamma: float, c: int, n_batches: int,
        max_iters: int, *, seed: int, tf32: bool = False):
    """A whole stride-sampled fit -> (medoids, cardinalities, [(cost,
    counts, iters)], [(medoids, cardinalities) after each batch])."""
    med, card, hist, states = None, None, [], []
    for i in range(n_batches):
        xb = x[i::n_batches].contiguous()
        st = batch_step(xb, gamma, c, max_iters, seed=seed, i=i,
                        medoids_in=med, card_in=card, tf32=tf32)
        med, card = st.medoids, st.cardinalities
        hist.append((st.inner.cost, st.inner.st.counts, st.inner.n_iter))
        states.append((med, card))
    return med, card, hist, states


def predict(x: torch.Tensor, medoids: torch.Tensor, gamma: float, *,
            tf32: bool = False) -> torch.Tensor:
    return torch.argmin(rbf_e(x, medoids, gamma, tf32=tf32), dim=1)
