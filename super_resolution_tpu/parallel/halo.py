"""Spatially tiled MAP objective with explicit halo exchange.

For HR images too large for one chip, the estimate is tiled over a
(``row``, ``col``) device mesh. The degradation stencil (translational warp +
PSF blur + decimation) reaches ``halo = ceil(max_shift) + 1 + kernel//2``
pixels past each tile edge, so:

- **forward**: each tile gathers a ``halo``-wide rim from its 4 neighbors
  (two ``ppermute`` rounds — rows then cols, which carries corners
  automatically), computes warp+blur on the padded tile, crops the center,
  and decimates. ``ppermute`` zero-fills edges with no sender, which is
  exactly the reference's BORDER_CONSTANT zero border.
- **adjoint**: the gradient is computed on a zero-embedded padded canvas and
  the rims are *scattered back* — sent to the owning neighbor and added
  (the exact adjoint of the halo gather), in reverse axis order.
- **cost**: per-tile partial sums reduced with ``psum`` over both mesh axes.

Tile sizes must be divisible by ``scale`` so local decimation equals the
cropped global decimation. The per-pixel TV term needs a radius-2 stencil for
its gradient, covered by a 2-pixel gather (no scatter needed: the gradient at
a pixel is a pure function of x within radius 2).

This is the hand-scheduled analog of what the XLA SPMD partitioner does for
spatially partitioned convolutions; owning the exchange keeps the collective
schedule explicit: one halo exchange per objective evaluation.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from super_resolution_tpu.ops.blur import blur as blur_op, blur_adjoint as blur_adjoint_op
from super_resolution_tpu.ops.resize import decimate, zero_upsample
from super_resolution_tpu.ops.tv import tv_cost_and_grad
from super_resolution_tpu.ops.warp import translate, translate_adjoint
from super_resolution_tpu.parallel.mesh import COL_AXIS, ROW_AXIS

__all__ = [
    "required_halo",
    "make_tiled_map_value_and_grad",
    "halo_gather",
    "halo_scatter_sum",
]


def required_halo(max_shift: float, kernel_size: int) -> int:
    """Stencil footprint of warp+blur: ceil(|shift|) + 1 (bilinear) + k//2."""
    return int(math.ceil(abs(max_shift))) + 1 + kernel_size // 2


def _replicate_edge(x: jnp.ndarray, halo: int, spatial_axis: int, leading: bool):
    idx = [slice(None)] * x.ndim
    idx[spatial_axis] = slice(0, 1) if leading else slice(-1, None)
    edge = x[tuple(idx)]
    return jnp.repeat(edge, halo, axis=spatial_axis)


def _exchange_axis(
    x: jnp.ndarray, halo: int, axis_name: str, n: int, spatial_axis: int,
    border: str = "zero",
):
    """Pad ``spatial_axis`` with ``halo`` rows from each neighbor along
    ``axis_name``. Global border fill: ``"zero"`` (BORDER_CONSTANT, for the
    warp/blur data term) or ``"edge"`` (replication, which makes forward
    differences vanish at the true image border — the TV truncation rule)."""
    if n == 1:
        if border == "edge":
            before = _replicate_edge(x, halo, spatial_axis, leading=True)
            after = _replicate_edge(x, halo, spatial_axis, leading=False)
            return jnp.concatenate([before, x, after], axis=spatial_axis)
        pad = [(0, 0)] * x.ndim
        pad[spatial_axis] = (halo, halo)
        return jnp.pad(x, pad)
    idx = [slice(None)] * x.ndim
    idx[spatial_axis] = slice(-halo, None)
    last = x[tuple(idx)]
    idx[spatial_axis] = slice(0, halo)
    first = x[tuple(idx)]
    # Tile i's leading pad comes from tile i-1's trailing rows.
    before = lax.ppermute(last, axis_name, [(i, i + 1) for i in range(n - 1)])
    # Tile i's trailing pad comes from tile i+1's leading rows.
    after = lax.ppermute(first, axis_name, [(i, i - 1) for i in range(1, n)])
    if border == "edge":
        pos = lax.axis_index(axis_name)
        before = jnp.where(
            pos == 0, _replicate_edge(x, halo, spatial_axis, leading=True), before
        )
        after = jnp.where(
            pos == n - 1, _replicate_edge(x, halo, spatial_axis, leading=False), after
        )
    return jnp.concatenate([before, x, after], axis=spatial_axis)


def halo_gather(
    x: jnp.ndarray, halo: int, n_row: int, n_col: int, border: str = "zero"
):
    """Gather a full halo rim: rows then cols (corners ride along)."""
    x = _exchange_axis(x, halo, ROW_AXIS, n_row, x.ndim - 2, border)
    x = _exchange_axis(x, halo, COL_AXIS, n_col, x.ndim - 1, border)
    return x


def _scatter_axis(g: jnp.ndarray, halo: int, axis_name: str, n: int, spatial_axis: int):
    """Adjoint of :func:`_exchange_axis`: crop the center and add the rims
    into the neighbors that own them."""
    size = g.shape[spatial_axis]
    idx = [slice(None)] * g.ndim
    idx[spatial_axis] = slice(halo, size - halo)
    center = g[tuple(idx)]
    if n == 1:
        return center
    idx[spatial_axis] = slice(0, halo)
    before_rim = g[tuple(idx)]
    idx[spatial_axis] = slice(size - halo, None)
    after_rim = g[tuple(idx)]
    # Tile i's leading rim overlaps tile i-1's trailing rows; send it there.
    recv_trailing = lax.ppermute(before_rim, axis_name, [(i, i - 1) for i in range(1, n)])
    # Tile i's trailing rim overlaps tile i+1's leading rows.
    recv_leading = lax.ppermute(after_rim, axis_name, [(i, i + 1) for i in range(n - 1)])
    csize = center.shape[spatial_axis]
    lead = [slice(None)] * g.ndim
    lead[spatial_axis] = slice(0, halo)
    trail = [slice(None)] * g.ndim
    trail[spatial_axis] = slice(csize - halo, None)
    center = center.at[tuple(lead)].add(recv_leading)
    center = center.at[tuple(trail)].add(recv_trailing)
    return center


def halo_scatter_sum(g: jnp.ndarray, halo: int, n_row: int, n_col: int):
    """Exact adjoint of :func:`halo_gather` (reverse axis order)."""
    g = _scatter_axis(g, halo, COL_AXIS, n_col, g.ndim - 1)
    g = _scatter_axis(g, halo, ROW_AXIS, n_row, g.ndim - 2)
    return g


def _btv_cost_and_grad_tiled(
    x2: jnp.ndarray,
    c2: jnp.ndarray,
    scale_range: int,
    spatial_decay: float,
    halo: int,
    u0: jnp.ndarray,
    v0: jnp.ndarray,
    h_glob: int,
    w_glob: int,
):
    """Coordinate-aware BTV on a halo-padded tile (``ops/btv.py`` semantics
    with explicit global masks).

    ``x2``/``c2``: tile padded by ``halo >= scale_range`` on every side
    (fill irrelevant — masked); ``(u0, v0)``: global coords of the padded
    tile's (0, 0). Returns the cost over OWNED pixels and the gradient on
    the owned crop. Exact because the gradient at an owned pixel p only
    involves sources within ``scale_range - 1`` up-left and window reads
    within ``scale_range`` down-right — all inside the padded tile — and
    every out-of-global position or offset is masked exactly like the
    single-device path masks at the true image border
    (``btv_regularizer.cpp:30,114,139``), including the image-origin
    source skip.
    """
    P, a = scale_range, spatial_decay
    hp, wp = x2.shape[-2], x2.shape[-1]
    uu = u0 + jnp.arange(hp)[:, None]
    vv = v0 + jnp.arange(wp)[None, :]
    dtype = x2.dtype
    valid = ((uu >= 0) & (uu < h_glob) & (vv >= 0) & (vv < w_glob)).astype(dtype)
    not_origin = 1.0 - ((uu == 0) & (vv == 0)).astype(dtype)

    def shifted_diff(i, j):
        if i == 0 and j == 0:
            return jnp.zeros_like(x2)
        in_window = ((uu + i < h_glob) & (vv + j < w_glob)).astype(dtype)
        d = x2[..., : hp - i, : wp - j] - x2[..., i:, j:]
        pad = [(0, 0)] * (x2.ndim - 2) + [(0, i), (0, j)]
        return jnp.pad(d, pad) * in_window * valid

    r = jnp.zeros_like(x2)
    for i in range(P + 1):
        for j in range(P + 1):
            r = r + (a ** (i + j)) * jnp.abs(shifted_diff(i, j))

    sl = (Ellipsis, slice(halo, hp - halo), slice(halo, wp - halo))
    cost = jnp.sum((c2 * r * r)[sl])

    g = 2.0 * c2 * r * valid
    grad = jnp.zeros_like(x2)
    for i in range(P):
        for j in range(P):
            t = (a ** (i + j)) * g * jnp.sign(shifted_diff(i, j))
            grad = grad + t
            t_masked = t * not_origin
            if i == 0 and j == 0:
                grad = grad - t_masked
            else:
                pad = [(0, 0)] * (x2.ndim - 2) + [(i, 0), (j, 0)]
                grad = grad - jnp.pad(
                    t_masked[..., : hp - i, : wp - j], pad
                )
    return cost, grad[sl]


def make_tiled_map_value_and_grad(
    mesh: Mesh,
    blur_kernel,
    scale: int,
    tv_lambda: float = 0.0,
    max_shift: int = 4,
    regularizers: Sequence[tuple[object, float]] = (),
    image_shape: tuple[int, int] | None = None,
):
    """Build ``value_and_grad(x, observations, shifts, reg_weights) ->
    (cost, grad)`` for spatially tiled global arrays.

    ``x``: ``[C, H, W]`` sharded PartitionSpec(None, 'row', 'col');
    ``observations``: ``[K, C, H/s, W/s]`` sharded (None, None, 'row', 'col');
    ``shifts``: ``[K, 2]`` replicated; ``reg_weights``: like x (IRLS weights).

    One regularizer is supported: 2D TV (also via the legacy ``tv_lambda``
    shorthand) or BTV (needs ``image_shape = (H, W)`` for its global border
    masks). Returns a function usable directly by
    :func:`...solvers.minimize` — the tiled objective is just another fused
    cost+grad.
    """
    from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu.ops.tv import TotalVariationRegularizer

    regs = tuple(regularizers)
    if tv_lambda > 0.0:
        if regs:
            raise ValueError("Pass tv_lambda OR regularizers, not both.")
        regs = ((TotalVariationRegularizer(), tv_lambda),)
    if len(regs) > 1:
        raise ValueError("The tiled objective supports at most one regularizer.")
    use_tv = bool(regs) and isinstance(regs[0][0], TotalVariationRegularizer)
    use_btv = bool(regs) and isinstance(
        regs[0][0], BilateralTotalVariationRegularizer
    )
    if use_tv and regs[0][0].use_3d:
        raise ValueError("3D spectral TV is band-coupled, not spatial; it "
                         "does not need the halo path.")
    if regs and not (use_tv or use_btv):
        raise ValueError(f"Unsupported regularizer type: {type(regs[0][0])!r}")
    if use_btv and image_shape is None:
        raise ValueError("Tiled BTV needs image_shape=(H, W) for its global "
                         "border masks.")
    reg_lambda = regs[0][1] if regs else 0.0

    # Row-only / col-only meshes are fine: the absent axis degrades to local
    # padding (n == 1 skips the ppermute) and must stay out of the specs.
    n_row = mesh.shape.get(ROW_AXIS, 1)
    n_col = mesh.shape.get(COL_AXIS, 1)
    row_name = ROW_AXIS if ROW_AXIS in mesh.axis_names else None
    col_name = COL_AXIS if COL_AXIS in mesh.axis_names else None
    kernel_size = 0 if blur_kernel is None else blur_kernel.shape[0]
    halo = required_halo(max_shift, kernel_size)
    # Single-hop exchange: each rim comes from the immediate neighbor, so the
    # halo cannot exceed the local tile extent (multi-hop would be needed).
    # Checked at call time against the actual local shapes.
    # The local translate's internal padding only needs to cover the shift.
    local_max_shift = int(math.ceil(max_shift)) + 1

    x_spec = PartitionSpec(None, row_name, col_name)
    obs_spec = PartitionSpec(None, None, row_name, col_name)

    def local_value_and_grad(x_local, obs_local, shifts, w_local):
        # --- Data term ---
        xp = halo_gather(x_local, halo, n_row, n_col)

        # Mask of padded-tile pixels inside the *global* image: the warp's
        # output is zero outside the global canvas (BORDER_CONSTANT) before
        # the blur sees it — without this, warped halo content leaks into the
        # blur at the true image border (visible for negative shifts).
        hp, wp = xp.shape[-2], xp.shape[-1]
        i = lax.axis_index(ROW_AXIS) if n_row > 1 else 0
        j = lax.axis_index(COL_AXIS) if n_col > 1 else 0
        ridx = jnp.arange(hp)
        cidx = jnp.arange(wp)
        rmask = jnp.where(jnp.equal(i, 0), ridx >= halo, True) & jnp.where(
            jnp.equal(i, n_row - 1), ridx < hp - halo, True
        )
        cmask = jnp.where(jnp.equal(j, 0), cidx >= halo, True) & jnp.where(
            jnp.equal(j, n_col - 1), cidx < wp - halo, True
        )
        inside = (rmask[:, None] & cmask[None, :]).astype(x_local.dtype)

        def per_frame(y_local, shift):
            z = translate(xp, shift[0], shift[1], max_shift=local_max_shift)
            z = z * inside
            if blur_kernel is not None:
                z = blur_op(z, blur_kernel)
            z = z[..., halo:-halo, halo:-halo]
            r = decimate(z, scale) - y_local
            cost_k = jnp.sum(r * r)
            # Adjoint on a zero-embedded padded canvas, rims scattered back
            # (adjoint of mask∘translate is translate^T∘mask).
            rp = zero_upsample(r, scale)
            pad = [(0, 0)] * (rp.ndim - 2) + [(halo, halo), (halo, halo)]
            rp = jnp.pad(rp, pad)
            if blur_kernel is not None:
                rp = blur_adjoint_op(rp, blur_kernel)
            rp = rp * inside
            rp = translate_adjoint(rp, shift[0], shift[1], max_shift=local_max_shift)
            return cost_k, rp

        costs, grads_padded = jax.vmap(per_frame)(obs_local, shifts)
        s2 = jnp.asarray(float(scale * scale), x_local.dtype)
        cost = s2 * jnp.sum(costs)
        grad_padded = 2.0 * s2 * jnp.sum(grads_padded, axis=0)
        grad = halo_scatter_sum(grad_padded, halo, n_row, n_col)

        # --- TV term (radius-2 stencil: gather-only with a 2-pixel rim) ---
        if use_tv:
            # Edge-replicated border fill makes forward diffs vanish at the
            # true image border, matching the reference truncation rule.
            x2 = halo_gather(x_local, 2, n_row, n_col, border="edge")
            w2 = halo_gather(w_local, 2, n_row, n_col, border="edge")
            _, tv_grad_pad = tv_cost_and_grad(x2, reg_lambda * w2)
            # Cost: per-pixel separable — sum only the pixels this tile owns.
            from super_resolution_tpu.ops.tv import tv_residuals

            r2 = tv_residuals(x2)
            owned = (reg_lambda * w2) * r2 * r2
            tv_cost = jnp.sum(owned[..., 2:-2, 2:-2])
            cost = cost + tv_cost
            # Gradient at owned pixels is a radius-2 function of x — but rim
            # pixels of the padded array have wrong residuals only beyond
            # radius 1, so the center crop of the padded gradient is exact.
            grad = grad + tv_grad_pad[..., 2:-2, 2:-2]
        elif use_btv:
            # Gather radius scale_range (window reads down-right, overlap
            # sources up-left); zero fill is fine — every out-of-global
            # position/offset is explicitly masked inside.
            reg = regs[0][0]
            P = reg.scale_range
            x2 = halo_gather(x_local, P, n_row, n_col)
            w2 = halo_gather(w_local, P, n_row, n_col)
            th, tw = x_local.shape[-2], x_local.shape[-1]
            i_t = lax.axis_index(ROW_AXIS) if n_row > 1 else 0
            j_t = lax.axis_index(COL_AXIS) if n_col > 1 else 0
            u0 = i_t * th - P
            v0 = j_t * tw - P
            btv_cost, btv_grad = _btv_cost_and_grad_tiled(
                x2, reg_lambda * w2, P, reg.spatial_decay, P,
                u0, v0, image_shape[0], image_shape[1],
            )
            cost = cost + btv_cost
            grad = grad + btv_grad
        if row_name is not None:
            cost = lax.psum(cost, ROW_AXIS)
        if col_name is not None:
            cost = lax.psum(cost, COL_AXIS)
        return cost, grad

    tiled = jax.shard_map(
        local_value_and_grad,
        mesh=mesh,
        in_specs=(x_spec, obs_spec, PartitionSpec(None, None), x_spec),
        out_specs=(PartitionSpec(), x_spec),
    )

    reg_halo = regs[0][0].scale_range if use_btv else (2 if use_tv else 0)

    def value_and_grad(x, observations, shifts, tv_weights=None):
        tile_h = x.shape[-2] // n_row
        tile_w = x.shape[-1] // n_col
        if max(halo, reg_halo) > min(tile_h, tile_w):
            raise ValueError(
                f"Stencil halo ({max(halo, reg_halo)}) exceeds the local tile "
                f"size ({tile_h}x{tile_w}); use fewer tiles, a larger image, "
                f"or a smaller max_shift (single-hop halo exchange)."
            )
        if tv_weights is None:
            tv_weights = jnp.ones_like(x)
        return tiled(x, observations, shifts, tv_weights)

    return value_and_grad
