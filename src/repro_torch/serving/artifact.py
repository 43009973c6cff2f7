"""Frozen predict artifact, the port of ``repro/serving/artifact.py``: the
immutable deployable of a finished fit.

``freeze(result)`` derives once what every query needs and packs it into
one ``FrozenArtifact``:

* the map tables: RFF frequencies and phases, Nystrom landmarks and their
  squared norms, count-sketch hash and sign, TensorSketch's stacks; stored
  at the tile dtype (``kernels/precision.py``; signs int8 under bf16);
* the centroids, their masked squared norms (+1e30 on empty clusters) and
  the value panel ``v``: ``proj @ centroids^T`` for Nystrom, the
  transposed centroids otherwise;
* for ``method="exact"`` fits, the global medoids, their kernel diagonal
  and the KernelSpec's scalars.

It also builds, once, what the card's launches would otherwise derive per
request (``FrozenArtifact.runtime``): the RFF phases as the [m] vector the
``embed_assign`` launch takes, and for the count sketch the bucket-sorted
tables and the ``sketch_assign`` gather program of the artifact's dtype
(whose build reads the tables on the host, which a captured CUDA graph
cannot do). So ``serving.assign`` runs one program per shape bucket over
these tensors and nothing else.

``save_artifact`` / ``load_artifact`` use the reference's npz layout: the
arrays (bf16 stored as its exact f32 lift, re-rounded at load) and a
``__meta__`` member holding JSON with kind, precision, statics and dtypes.
A file written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import _masked_csq
from repro_torch.kernels.precision import resolve_precision

#: artifact kinds (``MiniBatchConfig.method`` values)
KINDS = ("rff", "nystrom", "sketch", "tensorsketch", "exact")

#: kinds the fused kernels serve (``ops.predict_assign``); TensorSketch
#: (FFT convolution) and exact (medoid Gram columns) run their plain
#: PyTorch programs, one per bucket all the same
FUSED_KINDS = ("rff", "nystrom", "sketch")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int8": torch.int8, "int64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class FrozenArtifact:
    """Immutable predict artifact: ``arrays`` (name -> tensor, all on one
    device), ``statics`` (the scalars: map_kind, gamma, coef0, degree,
    scale, m, c, d, ...) and ``precision``, the tile dtype the map tables
    were frozen at. ``runtime`` is derived from them at construction."""

    kind: str
    precision: str
    arrays: dict
    statics: dict
    #: the fit's count-sketch map, if any: the runtime takes its bucket
    #: tables and gather programs instead of building them again
    source: dataclasses.InitVar[object] = None
    runtime: dict = dataclasses.field(init=False, repr=False)

    def __post_init__(self, source):
        if self.kind not in KINDS:
            raise ValueError(f"unknown artifact kind {self.kind!r}; have "
                             f"{KINDS}")
        object.__setattr__(self, "runtime", _runtime(self, source))

    @property
    def n_clusters(self) -> int:
        return int(self.statics["c"])

    @property
    def in_dim(self) -> int:
        return int(self.statics["d"])

    @property
    def dim(self) -> int:
        """Embedded dim m (C for exact: one medoid Gram column each)."""
        return int(self.statics.get("m", self.statics["c"]))

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device

    def feature_map(self):
        """The sketch kinds' map (signs lifted back to f32: +-1 is exact)."""
        from repro_torch.approx.sketch import CountSketchMap, TensorSketchMap
        a, s = self.arrays, self.statics
        if self.kind == "sketch":
            return CountSketchMap(h=a["h"], sign=a["sign"].to(torch.float32),
                                  m=int(s["m"]))
        if self.kind == "tensorsketch":
            return TensorSketchMap(hs=a["hs"],
                                   signs=a["signs"].to(torch.float32),
                                   m=int(s["m"]), degree=int(s["degree"]),
                                   gamma=float(s["gamma"]),
                                   coef0=float(s["coef0"]))
        raise ValueError(f"kind {self.kind!r} has no sketch map")

    def kernel_spec(self):
        """The KernelSpec of an exact-kind artifact."""
        from repro_torch.core.kernels import KernelSpec
        if self.kind != "exact":
            raise ValueError(f"kind {self.kind!r} carries no KernelSpec")
        s = self.statics
        return KernelSpec(name=s["kernel"], gamma=float(s["gamma"]),
                          coef0=float(s["coef0"]), degree=int(s["degree"]))


def _runtime(art: FrozenArtifact, source=None) -> dict:
    """What a request would otherwise derive: RFF's [m] phases, the exact
    kind's KernelSpec, TensorSketch's map with its sketch matrices built;
    for the count sketch its map (the CSR requests' O(nnz) embedding) and,
    on the card, its kernel tables and the gather program of the
    artifact's tile dtype, the ``source`` map's where the artifact was
    frozen from one (the fit built them already)."""
    a = art.arrays
    if art.kind == "rff":
        return {"b": a["aux"].reshape(-1).contiguous()}
    if art.kind == "exact":
        return {"spec": art.kernel_spec()}
    if art.kind == "tensorsketch":
        fmap = art.feature_map()
        fmap.matrices                    # built once, here
        return {"fmap": fmap}
    if art.kind == "sketch":
        fmap = art.feature_map() if source is None else source
        if not a["h"].is_cuda:
            return {"fmap": fmap}
        from repro_torch.kernels.sketch_assign import (chunk_features,
                                                       gather_program)
        itemsize = resolve_precision(art.precision).tile_itemsize
        order, offsets, sign = fmap.buckets
        kd = chunk_features(itemsize)
        if kd not in fmap.programs:
            fmap.programs[kd] = gather_program(order, offsets, sign, fmap.m,
                                               kd)
        return {"fmap": fmap, "tables": (order, offsets, sign, fmap.programs)}
    return {}


def _panels(centroids: torch.Tensor, counts: torch.Tensor):
    """f32 centroids, the transposed value panel and the masked norms."""
    c32, csq = _masked_csq(centroids, counts)
    return c32, c32.T.contiguous(), csq


def freeze_map(fmap, centroids: torch.Tensor, counts: torch.Tensor, *,
               precision: str = "f32") -> FrozenArtifact:
    """Freeze an embedded-space model (feature map + centroids). The map
    tables are stored at ``precision``'s tile dtype; panels and norms stay
    f32 (accumulator-side values, never tiles)."""
    p = resolve_precision(precision)
    counts = torch.as_tensor(counts, dtype=torch.float32).to(centroids.device)
    c32, v, csq = _panels(centroids, counts)
    c, m = c32.shape
    common = dict(c=int(c), m=int(m))
    panels = dict(v=v, csq=csq, centroids=c32, counts=counts)
    if fmap.kind == "rff":
        arrays = dict(w=p.cast_tiles(fmap.w).contiguous(),
                      aux=fmap.b.to(torch.float32)[:, None].contiguous(),
                      **panels)
        statics = dict(map_kind="rff", gamma=1.0, coef0=1.0, degree=1,
                       scale=float(fmap.scale), d=int(fmap.in_dim), **common)
    elif fmap.kind == "nystrom":
        w = p.cast_tiles(fmap.landmarks).contiguous()
        # the norms of the CAST landmarks, as the kernel sums them
        aux = torch.sum(w.to(torch.float32) ** 2, dim=1, keepdim=True)
        spec = fmap.spec
        arrays = dict(w=w, aux=aux, **panels)
        arrays["v"] = (fmap.proj.to(torch.float32) @ c32.T).contiguous()
        statics = dict(map_kind=spec.name, gamma=float(spec.gamma),
                       coef0=float(spec.coef0), degree=int(spec.degree),
                       scale=1.0, d=int(fmap.in_dim), **common)
    elif fmap.kind == "sketch":
        arrays = dict(h=fmap.h.to(torch.int32),
                      sign=fmap.sign.to(p.sign_dtype), **panels)
        statics = dict(map_kind="sketch", d=int(fmap.in_dim), **common)
    elif fmap.kind == "tensorsketch":
        arrays = dict(hs=fmap.hs.to(torch.int32),
                      signs=fmap.signs.to(p.sign_dtype), **panels)
        statics = dict(map_kind="tensorsketch", degree=int(fmap.degree),
                       gamma=float(fmap.gamma), coef0=float(fmap.coef0),
                       d=int(fmap.in_dim), **common)
    else:
        raise TypeError(f"unsupported feature map {type(fmap).__name__}")
    return FrozenArtifact(fmap.kind, p.tile, arrays, statics,
                          fmap if fmap.kind == "sketch" else None)


def freeze(result, *, precision: str = "f32") -> FrozenArtifact:
    """``FitResult`` -> ``FrozenArtifact``. At f32 it labels as the fit's
    own f32 path does; ``precision="bf16"`` stores the map tables in bf16
    (every consumer still sums in f32)."""
    if result.fmap is not None:
        return freeze_map(result.fmap, result.state.centroids,
                          result.state.cardinalities, precision=precision)
    if result.spec is None:
        raise ValueError(
            "cannot freeze an exact-path FitResult without its KernelSpec "
            "(FitResult.spec): prediction would use the wrong kernel")
    state, spec = result.state, result.spec
    c, d = state.medoids.shape
    arrays = dict(medoids=state.medoids.to(torch.float32),
                  medoid_diag=state.medoid_diag.to(torch.float32))
    statics = dict(kernel=spec.name, gamma=float(spec.gamma),
                   coef0=float(spec.coef0), degree=int(spec.degree),
                   c=int(c), d=int(d))
    return FrozenArtifact("exact", resolve_precision(precision).tile, arrays,
                          statics)


def artifact_nbytes(art: FrozenArtifact) -> int:
    """Resident bytes of the artifact's arrays (what
    ``core.memory.serve_footprint_bytes`` prices at bucket=0)."""
    return int(sum(a.numel() * a.element_size() for a in art.arrays.values()))


def save_artifact(art: FrozenArtifact, path: str) -> str:
    """Write one ``.npz``: the arrays and a ``__meta__`` JSON member with
    kind, precision, statics and dtypes; bf16 arrays as their f32 lift."""
    arrays, dtypes = {}, {}
    for k, a in art.arrays.items():
        dtypes[k] = _NAMES[a.dtype]
        if a.dtype == torch.bfloat16:
            a = a.to(torch.float32)
        arrays[k] = a.cpu().numpy()
    meta = json.dumps({"kind": art.kind, "precision": art.precision,
                       "statics": art.statics, "dtypes": dtypes})
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
    return path


def load_artifact(path: str, *, device=None) -> FrozenArtifact:
    """Read a ``save_artifact`` file (of either package) onto ``device``
    (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: torch.from_numpy(np.asarray(z[k])).to(dev).to(
                      _DTYPES[dt]) for k, dt in meta["dtypes"].items()}
    return FrozenArtifact(kind=meta["kind"], precision=meta["precision"],
                          arrays=arrays, statics=meta["statics"])
