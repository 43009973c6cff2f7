"""Dense SwiGLU FFN and capacity-based top-k MoE (the port of
``repro/models/mlp.py``).

The MoE is the reference's sort-free capacity dispatch: each (token, k)
slot goes to position ``pos`` of its expert's buffer, ``pos`` being the
number of earlier slots (token-major, then k) that chose that expert; slots
at or past the capacity are dropped and contribute 0 (the residual carries
the token). Routing equals the reference's exactly: the router logits in
f32, the top k in descending order with equal logits keeping the lower
expert first (a stable sort, as ``jax.lax.top_k`` orders them), a softmax
over the k logits cast to x's dtype. The expert products are ``einsum``
calls, as the reference computes them outside any Pallas kernel.

``moe_block_ep`` is the expert-parallel dispatch: the grouped path
(``_moe_block_ep_grouped``, the reference's ``_moe_block_ep_gspmd``:
capacity per group of tokens) in one process, and the all_to_all path
(``_moe_block_ep_all_to_all``, the reference's ``_moe_block_ep_shardmap``)
when ``tp``'s mesh has a ``data`` axis.

Over a model axis (``tp`` of M ranks): the dense SwiGLU splits w_gate and
w_up by columns and w_down by rows, and the ranks' outputs are summed; the
MoE splits every expert's d_ff (e_gate / e_up [E, D, F/M], e_down [E, F/M,
D]) and keeps the router whole, so every rank routes alike and the
combined outputs are summed.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from .common import TP, TP1, ParamBuilder, swiglu


def init_mlp(b: ParamBuilder, d_model: int, d_ff: int, prefix: str = ""):
    b.dense(prefix + "w_gate", (d_model, d_ff))
    b.dense(prefix + "w_up", (d_model, d_ff))
    b.dense(prefix + "w_down", (d_ff, d_model))


def mlp_block(p, x: torch.Tensor, prefix: str = "",
              tp: TP = TP1) -> torch.Tensor:
    x = tp.copy(x)
    h = swiglu(x @ p[prefix + "w_gate"], x @ p[prefix + "w_up"])
    return tp.reduce(h @ p[prefix + "w_down"])


def init_moe(b: ParamBuilder, cfg: ModelConfig, prefix: str = ""):
    """router [D, E] drawn in f32 (as the reference draws it); the experts
    e_gate / e_up [E, D, F] and e_down [E, F, D] in the builder's dtype."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    b.dense(prefix + "router", (d, e), dtype=torch.float32)
    b.dense(prefix + "e_gate", (e, d, f))
    b.dense(prefix + "e_up", (e, d, f))
    b.dense(prefix + "e_down", (e, f, d))


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x [..., D] -> (top_w [..., k] in x's dtype, top_e [..., k] int64).
    The logits are f32 (the reference's bf16 @ f32 promotes; torch needs
    the cast); the top k sort stably, so equal logits keep the lower
    expert first, as ``jax.lax.top_k`` does."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_w = torch.softmax(vals[..., :k], dim=-1).to(x.dtype)
    return top_w, idx[..., :k]


def slot_positions(e_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """e_ids [..., N] -> each slot's position in its expert's buffer: the
    exclusive count of earlier slots (along the last dim) with the same
    expert."""
    onehot = torch.nn.functional.one_hot(e_ids, n_experts)
    pos_all = torch.cumsum(onehot, dim=-2) - onehot
    return torch.sum(pos_all * onehot, dim=-1)


def _experts(buf, wg, wu, wd, spec: str):
    """SwiGLU experts over a dispatch buffer; ``spec`` names buf's dims
    (``ecd`` or ``gecd``)."""
    out = spec.replace("d", "f")
    h = swiglu(torch.einsum(f"{spec},edf->{out}", buf, wg),
               torch.einsum(f"{spec},edf->{out}", buf, wu))
    return torch.einsum(f"{out},efd->{spec}", h, wd)


def _dispatch(x_slots, slot, kept, n_slots):
    """The [n_slots, D] buffer holding each kept slot's row at ``slot``.
    A dropped slot writes a spare row past the end, which is cut off, so
    the dispatch has static shapes and no host read."""
    d = x_slots.shape[-1]
    idx = torch.where(kept, slot, torch.full_like(slot, n_slots)).reshape(-1)
    buf = x_slots.new_zeros((n_slots + 1, d)).index_put(
        (idx,), x_slots.reshape(-1, d))
    return buf[:n_slots]


def _combine(y_flat, slot, kept, top_w, shape):
    """Each slot's expert output (0 where dropped) times its weight, summed
    over k: y_flat [slots, D] -> [*shape[:-1], D] (shape = (..., k, D))."""
    out = y_flat[torch.where(kept, slot, torch.zeros_like(slot))]
    out = torch.where(kept[..., None], out, torch.zeros_like(out))
    out = out * top_w.reshape(kept.shape)[..., None]
    return out.reshape(shape).sum(dim=-2)


def moe_block(p, x: torch.Tensor, cfg: ModelConfig,
              prefix: str = "", tp: TP = TP1) -> torch.Tensor:
    """Top-k capacity-dropping MoE. x: [B, S, D] -> [B, S, D], with one
    global capacity max(128, ceil128(T k / E cf)). Dispatches to the
    expert-parallel path when ``cfg.moe_ep_groups`` is set."""
    if cfg.moe_ep_groups:
        return moe_block_ep(p, x, cfg, prefix=prefix, tp=tp)
    x = tp.copy(x)
    bsz, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = bsz * s
    xt = x.reshape(t, d)
    cap = int(t * k / e * cfg.capacity_factor)
    cap = max(128, -(-cap // 128) * 128)           # lane-aligned

    top_w, top_e = route(xt, tp.copy(p[prefix + "router"]), k)   # [T, k]
    e_ids = top_e.reshape(-1)                                     # [T*k]
    pos = slot_positions(e_ids, e)
    kept = pos < cap
    slot = e_ids * cap + pos
    buf = _dispatch(xt.repeat_interleave(k, dim=0), slot, kept, e * cap)
    y = _experts(buf.reshape(e, cap, d), p[prefix + "e_gate"],
                 p[prefix + "e_up"], p[prefix + "e_down"], "ecd")
    out = _combine(y.reshape(e * cap, d), slot, kept, top_w, (t, k, d))
    return tp.reduce(out.reshape(bsz, s, d))


def moe_block_ep(p, x: torch.Tensor, cfg: ModelConfig,
                 prefix: str = "", tp: TP = TP1) -> torch.Tensor:
    """Expert-parallel top-k MoE: the all_to_all dispatch when ``tp``'s
    mesh has a ``data`` axis, else the grouped path."""
    mesh = tp.mesh
    if mesh is not None and "data" in mesh.mesh_dim_names:
        return _moe_block_ep_all_to_all(p, x, cfg, mesh, prefix=prefix,
                                        tp=tp)
    if tp.size > 1:
        raise ValueError("the expert-parallel MoE over a model axis needs a "
                         "mesh with a data axis")
    return _moe_block_ep_grouped(p, x, cfg, prefix=prefix)


def _moe_block_ep_grouped(p, x: torch.Tensor, cfg: ModelConfig,
                          prefix: str = "") -> torch.Tensor:
    """The reference's ``_moe_block_ep_gspmd`` in one process: the tokens
    split into G = ``moe_ep_groups`` groups with a capacity PER GROUP,
    max(8, ceil8(T_g k / E cf)); slots index one flat [G E cap] buffer, a
    drop being a slot past its group's capacity."""
    bsz, s, d = x.shape
    e, k, g = cfg.n_experts, cfg.moe_top_k, cfg.moe_ep_groups
    t = bsz * s
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    tg = t // g
    cap = int(tg * k / e * cfg.capacity_factor)
    cap = max(8, -(-cap // 8) * 8)

    xt = x.reshape(g, tg, d)
    top_w, top_e = route(xt, p[prefix + "router"], k)        # [G, TG, k]
    e_ids = top_e.reshape(g, tg * k)
    pos = slot_positions(e_ids, e)                           # [G, TG*k]
    kept = pos < cap
    groups = torch.arange(g, device=x.device)[:, None]
    slot = groups * (e * cap) + e_ids * cap + pos
    buf = _dispatch(xt.repeat_interleave(k, dim=1), slot, kept, g * e * cap)
    y = _experts(buf.reshape(g, e, cap, d), p[prefix + "e_gate"],
                 p[prefix + "e_up"], p[prefix + "e_down"], "gecd")
    out = _combine(y.reshape(g * e * cap, d), slot, kept, top_w,
                   (g, tg, k, d))
    return out.reshape(bsz, s, d)


def _moe_block_ep_all_to_all(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                             prefix: str = "",
                             tp: TP = TP1) -> torch.Tensor:
    """The reference's ``_moe_block_ep_shardmap`` across ranks: x is this
    rank's share of the batch. Its tokens route into a LOCAL [E, cap_l, D]
    buffer (cap_l = max(8, ceil8(T_l k / E cf))); ONE all_to_all over
    ``data`` moves each expert's slots to the rank that owns it (rank r
    owns experts [r E/P, (r + 1) E/P) and uses only that slice of the
    expert weights it holds), and ONE moves the outputs back. The exchange
    is differentiable (its backward is the reverse all_to_all), so a
    rank's expert gradients sum every rank's tokens.

    Over a model axis of M ranks (``tp``; each rank's experts hold F/M of
    d_ff) the reference's tokens split over ``model`` along the sequence
    when S % M == 0, so each model rank routes its own S/M positions with
    cap_l from its own tokens (every rank routes all S otherwise). After
    the ``data`` exchange ONE all_gather over ``model`` assembles every
    model rank's slots for the F-split experts and ONE reduce_scatter
    returns each rank its own slots summed over F; the outputs of the S/M
    positions are gathered whole over ``model`` at the end. The all_gather
    only concatenates buffers, so it changes no drop."""
    from repro_torch.distributed import mesh as dmesh
    shape = dmesh.mesh_shape(mesh)
    e, k = cfg.n_experts, cfg.moe_top_k
    dpd = shape["data"]
    if e % dpd:
        raise ValueError(f"{e} experts do not split over {dpd} data ranks")
    el = e // dpd
    r = dmesh.axis_rank(mesh, "data")
    split = tp.size > 1 and x.shape[1] % tp.size == 0
    router = p[prefix + "router"]
    if split:   # this model rank's positions; the router's grads sum
        x, router = tp.split(x, 1), tp.copy(router)
    bl, sl, d = x.shape
    tl = bl * sl
    xt = x.reshape(tl, d)
    capl = max(8, -(-int(tl * k / e * cfg.capacity_factor) // 8) * 8)

    top_w, top_e = route(xt, router, k)
    e_ids = top_e.reshape(-1)
    pos = slot_positions(e_ids, e)
    kept = pos < capl
    slot = e_ids * capl + pos
    buf = _dispatch(xt.repeat_interleave(k, dim=0), slot, kept, e * capl)
    if dpd > 1:   # tokens -> expert owners: [P, E/P, cap_l, D] from each rank
        buf = dmesh.all_to_all(buf.reshape(e, capl, d), mesh, "data")
        buf = buf.reshape(dpd, el, capl, d).transpose(0, 1)
    own = slice(r * el, (r + 1) * el)
    buf = buf.reshape(el, dpd * capl, d)
    if tp.size > 1:   # every model rank's slots: [E/P, M P cap_l, D]
        buf = dmesh.all_gather_dim(buf, tp.mesh, 1)
    y = _experts(buf, p[prefix + "e_gate"][own],
                 p[prefix + "e_up"][own], p[prefix + "e_down"][own], "ecd")
    if tp.size > 1:   # this model rank's slots, summed over F
        y = dmesh.reduce_scatter(y, tp.mesh, 1)
    if dpd > 1:   # back to the tokens' ranks: [E, cap_l, D]
        y = y.reshape(el, dpd, capl, d).transpose(0, 1)
        y = dmesh.all_to_all(y.reshape(e, capl, d), mesh, "data")
    out = _combine(y.reshape(e * capl, d), slot, kept, top_w, (tl, k, d))
    out = out.reshape(bl, sl, d)
    return tp.gather(out, 1) if split else out
