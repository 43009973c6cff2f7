"""Landmark selection strategies, the port of ``repro/approx/selectors.py``.

Which m rows represent a kernel best decides the quality of every rank-m
approximation here: the exact path's Eq.14 landmark restriction and the
Nystrom map. A selector is a frozen dataclass with two faces:

* **offline**: ``select_indices(key, x, m, spec) -> [m] sorted int64``
  picks m rows of a resident sample ``x`` [n, d];
* **streaming**: ``init(key, d)`` / ``fold(state, xb)`` /
  ``finalize(state, m, spec)`` fold dense mini-batches into a bounded
  ``SelectorState`` (a candidate pool) and select from it.

Strategies:

* ``uniform``: the paper's §3.2 uniform sample (``choose_landmarks``);
* ``rls``: approximate ridge leverage scores. A uniform pilot S of m rows
  whitens the sample, ``C = K(X, S) K_SS^{-1/2}``, the m x m sketch
  ``G = C^T C`` gives

      score_i = c_i (G + lam I)^{-1} c_i^T + (k_ii - |c_i|^2)_+ / lam

  and m rows are drawn ~ score without replacement by a Gumbel top-m;
* ``kpp``: kernel k-means++ with m seeds (``core.init.kmeans_pp_indices``).

Randomness. The reference keys each row's draw by ``fold_in(fold_in(key,
tag), gid)``, gid the row's global id, so a streaming fold does not depend
on how the stream was chunked and a resumed fold selects what an
uninterrupted one does. Threefry does not exist in torch; the port draws
the same way from ``keyed_uniform``: U(0, 1) as a pure function of (key,
tag, gid), a splitmix64 hash in int64 tensor arithmetic that gives bitwise
the same values on the CPU and on the card. A key is a 62-bit integer; the
fit path draws it once from its batch's ``torch.Generator``
(``key_from``). ``uniform`` is the exception: given a generator it draws
exactly as ``choose_landmarks(gen, n, m)`` always did, so uniform fits do
not move; given an integer key it seeds a generator from it. The selection
steps (``RLSSelector.pilot_indices``, ``gumbel_top_m``) take the per-row
draws as tensors, so a test can hand them the reference's draws.

Top-m selections sort stably (descending), so equal draws keep the lower
index first, as ``jax.lax.top_k`` does, on either device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import torch

from repro_torch.data.loader import closing_source
from repro_torch.data.sparse import is_sparse
from repro_torch.device import resolve_device

NAMES = ("uniform", "rls", "kpp")

# per-concern streams: pool priorities, the RLS pilot, the final draw
_TAG_POOL, _TAG_PILOT, _TAG_SELECT = 0, 1, 2

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 value torch stores for it."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch shifts
    arithmetically)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors (multiplication wraps
    modulo 2^64 on both devices)."""
    z = (z ^ _shr(z, 30)) * _signed(_MIX1)
    z = (z ^ _shr(z, 27)) * _signed(_MIX2)
    return z ^ _shr(z, 31)


def _stream_base(key: int, tag: int) -> int:
    """The int64 base of (key, tag)'s stream: splitmix64 of key + (tag + 1)
    golden-ratio steps, in Python integers."""
    z = (int(key) + (tag + 1) * _GOLDEN) & _MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
    return _signed(z ^ (z >> 31))


def keyed_uniform(key: int, tag: int, gids: torch.Tensor) -> torch.Tensor:
    """One U(0, 1) f32 draw per global row id, a pure function of (key,
    tag, gid): the top 24 bits of splitmix64(base + golden * (gid + 1)),
    as (bits + 0.5) / 2^24, exact in f32. On ``gids``' device."""
    z = _signed(_stream_base(key, tag)) + (gids.to(torch.int64) + 1) \
        * _signed(_GOLDEN)
    bits = _shr(_splitmix64(z), 40)
    return (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def keyed_gumbel(key: int, tag: int, gids: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise per global row id from ``keyed_uniform``, f32.
    The logs run in f64 and round once to f32, so the CPU's and the card's
    log (which differ in the last f32 bit) give the same noise."""
    u = torch.clamp(keyed_uniform(key, tag, gids).to(torch.float64), 1e-12,
                    1.0 - 1e-7)
    return (-torch.log(-torch.log(u))).to(torch.float32)


def key_from(gen: torch.Generator) -> int:
    """A selection key drawn once from a CPU generator."""
    return int(torch.randint(0, 1 << 62, (1,), generator=gen))


def _top_m(values: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest values, ties to the lower index, sorted."""
    order = torch.sort(values, descending=True, stable=True).indices[:m]
    return torch.sort(order).values


class SelectorState(NamedTuple):
    """Streaming fold state: up to ``pool`` candidate rows in global-id
    order, each with its keyed uniform priority. Eviction keeps the running
    top-``pool`` priorities, so the fold is independent of chunking."""
    key: torch.Tensor        # [] int64, the selection key
    rows: torch.Tensor       # [r, d] f32 candidate rows
    gids: torch.Tensor       # [r] int64 global row ids (ascending)
    pri: torch.Tensor        # [r] f32 priorities
    rows_seen: torch.Tensor  # [] int64, the next global row id
    folds: torch.Tensor      # [] int64, batches folded


def rls_scores(c: torch.Tensor, diag_k: torch.Tensor, g: torch.Tensor, *,
               delta: float) -> torch.Tensor:
    """Approximate ridge leverage scores from pilot coordinates ``c``
    [n, m], the kernel diagonal ``diag_k`` [n] and the sketch ``g = c^T c``
    [m, m]; the ridge is lam = delta tr(g) / m."""
    m = g.shape[0]
    lam = delta * torch.trace(g) / m + 1e-12
    b = g + lam * torch.eye(m, dtype=torch.float32, device=g.device)
    sol = torch.linalg.solve(b, c.T)                           # [m, n]
    proj = torch.sum(c * sol.T, dim=1)
    resid = torch.clamp(diag_k.to(torch.float32) - torch.sum(c * c, dim=1),
                        min=0.0)
    return proj + resid / lam


def pilot_whitening(pilot: torch.Tensor, spec, *,
                    eps: float = 1e-6) -> torch.Tensor:
    """K_SS^{-1/2} by the Nystrom map's own clamped ``eigh``
    (``nystrom.whiten_gram``)."""
    from .nystrom import whiten_gram
    return whiten_gram(spec(pilot, pilot).to(torch.float32), eps=eps)


def _check_dense(xb) -> None:
    if is_sparse(xb):
        raise ValueError(
            "landmark selection needs dense rows (Nystrom gathers landmark "
            "coordinates); densify the selection sample or use a sketch "
            "method")


@dataclasses.dataclass(frozen=True)
class LandmarkSelector:
    """The shared contract and the streaming pool (module docstring)."""

    pool: int = 8192   # candidate-pool cap of the streaming fold

    name = "base"

    def _indices(self, key, x: torch.Tensor, gids: torch.Tensor, m: int,
                 spec) -> torch.Tensor:
        raise NotImplementedError

    # -- offline ----------------------------------------------------------

    def select_indices(self, key, x: torch.Tensor, m: int,
                       spec) -> torch.Tensor:
        """[m] sorted int64 indices into the resident sample ``x``, on its
        device. ``key``: an integer key, or a CPU generator to draw one
        from (``uniform`` draws from the generator itself)."""
        n = x.shape[0]
        if m > n:
            raise ValueError(f"|L|={m} > sample rows {n}")
        if m == n:
            return torch.arange(n, device=x.device)
        gids = torch.arange(n, device=x.device)
        return self._indices(key, x, gids, m, spec)

    def select(self, key, x: torch.Tensor, m: int, spec) -> torch.Tensor:
        """[m, d] landmark rows of a resident sample."""
        return x[self.select_indices(key, x, m, spec)]

    # -- streaming --------------------------------------------------------

    def init(self, key: int, d: int, *, device=None) -> SelectorState:
        dev = resolve_device(device)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return SelectorState(
            key=torch.tensor(int(key), dtype=torch.int64, device=dev),
            rows=torch.zeros((0, d), dtype=torch.float32, device=dev),
            gids=torch.zeros((0,), dtype=torch.int64, device=dev),
            pri=torch.zeros((0,), dtype=torch.float32, device=dev),
            rows_seen=zero, folds=zero)

    def fold(self, state: SelectorState, xb) -> SelectorState:
        """Fold one dense mini-batch into the candidate pool."""
        _check_dense(xb)
        dev = state.rows.device
        xb = torch.as_tensor(xb, dtype=torch.float32).to(dev)
        n = xb.shape[0]
        gids_new = state.rows_seen + torch.arange(n, device=dev)
        pri_new = keyed_uniform(int(state.key), _TAG_POOL, gids_new)
        rows = torch.cat([state.rows, xb])
        gids = torch.cat([state.gids, gids_new])
        pri = torch.cat([state.pri, pri_new])
        if rows.shape[0] > self.pool:
            # the top-`pool` of a union is the fold of per-batch top-`pool`s
            keep = _top_m(pri, self.pool)
            rows, gids, pri = rows[keep], gids[keep], pri[keep]
        return SelectorState(key=state.key, rows=rows, gids=gids, pri=pri,
                             rows_seen=state.rows_seen + n,
                             folds=state.folds + 1)

    def finalize(self, state: SelectorState, m: int, spec) -> torch.Tensor:
        """[m, d] landmark rows from the folded pool: those ``select``
        picks from the concatenated stream whenever it fit the pool."""
        n = int(state.rows.shape[0])
        if n < 1:
            raise ValueError("empty selector state: fold at least one batch")
        if m > n:
            raise ValueError(f"|L|={m} > pooled candidate rows {n}")
        if m == n:
            return state.rows
        return state.rows[self._indices(int(state.key), state.rows,
                                        state.gids, m, spec)]


def _as_key(key) -> int:
    return key_from(key) if isinstance(key, torch.Generator) else int(key)


@dataclasses.dataclass(frozen=True)
class UniformSelector(LandmarkSelector):
    """The paper's §3.2 uniform landmark sample (sorted, no replacement)."""

    name = "uniform"

    def _indices(self, key, x, gids, m, spec):
        from repro_torch.core.landmarks import choose_landmarks
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator().manual_seed(int(key))
        return choose_landmarks(gen, x.shape[0], m).to(x.device)


@dataclasses.dataclass(frozen=True)
class RLSSelector(LandmarkSelector):
    """Approximate ridge-leverage-score sampling (module docstring)."""

    delta: float = 1e-2   # ridge: lam = delta tr(G) / m
    eps: float = 1e-6     # pilot whitening clamp

    name = "rls"

    @staticmethod
    def pilot_indices(pri: torch.Tensor, m: int) -> torch.Tensor:
        """[m] sorted indices of the uniform pilot: the m largest of the
        per-row priorities ``pri``."""
        return _top_m(pri, m)

    @staticmethod
    def gumbel_top_m(scores: torch.Tensor, noise: torch.Tensor,
                     m: int) -> torch.Tensor:
        """Sample m indices ~ scores without replacement: the m largest
        log-scores plus the per-row Gumbel ``noise``, sorted."""
        return _top_m(torch.log(torch.clamp(scores, min=1e-30)) + noise, m)

    def scores(self, x: torch.Tensor, pilot_idx: torch.Tensor,
               spec) -> torch.Tensor:
        """[n] leverage estimates of the rows of ``x`` against the pilot
        rows ``x[pilot_idx]`` (no draw applied)."""
        pilot = x[pilot_idx]
        c = spec(x, pilot).to(torch.float32) @ pilot_whitening(
            pilot, spec, eps=self.eps)                              # [n, m]
        return rls_scores(c, spec.diag(x), c.T @ c, delta=self.delta)

    def _indices(self, key, x, gids, m, spec):
        key = _as_key(key)
        pidx = self.pilot_indices(keyed_uniform(key, _TAG_PILOT, gids), m)
        return self.gumbel_top_m(self.scores(x, pidx, spec),
                                 keyed_gumbel(key, _TAG_SELECT, gids), m)


@dataclasses.dataclass(frozen=True)
class KPPSelector(LandmarkSelector):
    """Kernel k-means++ landmark seeding (the greedy candidate variant)."""

    name = "kpp"

    def _indices(self, key, x, gids, m, spec):
        from repro_torch.core.init import kmeans_pp_indices
        gen = torch.Generator().manual_seed(
            _stream_base(_as_key(key), _TAG_SELECT) & ((1 << 63) - 1))
        idx = kmeans_pp_indices(x, spec.diag(x), gen, n_clusters=m,
                                spec=spec)
        return torch.sort(idx).values


_REGISTRY = {"uniform": UniformSelector(), "rls": RLSSelector(),
             "kpp": KPPSelector()}

SelectorLike = Union[str, LandmarkSelector, None]


def resolve(selector: SelectorLike) -> LandmarkSelector:
    """Name or instance -> selector instance (None -> uniform)."""
    if selector is None:
        return _REGISTRY["uniform"]
    if isinstance(selector, LandmarkSelector):
        return selector
    try:
        return _REGISTRY[selector]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown landmark selector {selector!r}; have {NAMES}") from None


def name_of(selector: SelectorLike) -> str:
    return resolve(selector).name


def select_streaming(selector: SelectorLike, key: int, batches, m: int,
                     spec, *, state: SelectorState | None = None,
                     checkpoint_cb=None, device=None):
    """Fold an iterable of dense row blocks or a ``data.loader.BatchSource``
    and select m landmarks, in one pass over at most ``selector.pool``
    rows. A closable source is closed on exit, success or failure.
    ``state`` resumes an earlier fold (skip the committed prefix first with
    ``source.skip(int(state.folds))``); ``checkpoint_cb(state, i)`` runs
    after every fold. A CSR block raises the needs-dense-rows
    ``ValueError``, as in the reference. Returns ``(landmarks [m, d],
    final_state)``."""
    sel = resolve(selector)
    start = int(state.folds) if state is not None else 0
    with closing_source(batches):
        for i, xb in enumerate(batches, start=start):
            _check_dense(xb)
            if state is None:
                state = sel.init(key, xb.shape[1], device=device)
            state = sel.fold(state, xb)
            if checkpoint_cb is not None:
                checkpoint_cb(state, i)
    if state is None:
        raise ValueError("empty batch iterable")
    return sel.finalize(state, m, spec), state


def state_like(d: int, *, device=None) -> SelectorState:
    """An empty state of width d (the structure a restore fills in)."""
    return UniformSelector().init(0, d, device=device)


__all__ = [
    "NAMES", "LandmarkSelector", "SelectorState",
    "UniformSelector", "RLSSelector", "KPPSelector",
    "resolve", "name_of", "select_streaming", "state_like",
    "rls_scores", "pilot_whitening", "keyed_uniform", "keyed_gumbel",
    "key_from",
]
