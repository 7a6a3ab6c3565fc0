"""Differentiable node splitting with gradients for discrete events (port of
nn_bvh_tpu/learn/splitter.py).

- gen_nodes: theta in [0, 1] -> axis plane offset and the two child AABBs.
- gen_nodes_epo: child bounds from primitive-midpoint classification, with
  finite-difference step gradients to the next discrete event
  (left_child_bound, right_child_bound).
- ql_points / ql_prims: differentiable count of points / primitive
  midpoints left of the plane.
- soft_min: hard min forward, softmax(-t x) backward.
- w_epo: differentiable overlapped surface area (the EPO term); its
  gradient is the surface of the next primitive to stop intersecting over
  the distance to that event.

The six JAX custom VJPs are torch.autograd.Functions. A backward returns a
gradient only for the inputs JAX's *_bwd returns one for (`offset`;
`node_min`/`node_max`; `vals`) and None for every other input: JAX's None
is a zero cotangent, and it cuts paths (the level bounds that
gen_nodes_epo passes as parent_min/parent_max) that a plain autograd trace
would keep. These gradients are event slopes, not derivatives, so
torch.autograd.gradcheck does not apply; the tests hold them against
jax.vjp. Every function batches over arbitrary leading axes (B and the
level's node axis K).
"""

from __future__ import annotations

import torch

from . import common
from .common import BIG

_GRAD_CLIP = 1.0 / 1e-4  # reference clip_by_value(slope, 0, 1/0.0001)

f32 = torch.float32


def _set(v: torch.Tensor, a: int, x: torch.Tensor) -> torch.Tensor:
    """v (..., 3) with component a replaced by x (...,), out of place."""
    return torch.stack([x if i == a else v[..., i] for i in range(3)], -1)


def _in_node(g, offset, parent_min, parent_max):
    """Zero the gradient where the offset lies outside the parent node."""
    return g * (offset >= parent_min).to(f32) * (offset <= parent_max).to(f32)


# ---------------------------------------------------------------------------
# simple box splitter (SAH/point variant)
# ---------------------------------------------------------------------------

def gen_nodes(bounds: torch.Tensor, thetas: torch.Tensor):
    """bounds (..., 6), thetas (..., 3) -> (offsets (..., 3),
    child_bounds (..., 6 children, 6)) ordered [xL xR yL yR zL zR]."""
    bmin = bounds[..., 0:3]
    bmax = bounds[..., 3:6]
    offsets = bmin + thetas * (bmax - bmin)
    children = []
    for a in range(3):
        c = common.clip(offsets[..., a], bmin[..., a], bmax[..., a])
        children.append(torch.cat([bmin, _set(bmax, a, c)], -1))
        children.append(torch.cat([_set(bmin, a, c), bmax], -1))
    return offsets, torch.stack(children, -2)


# ---------------------------------------------------------------------------
# counts left of the plane
# ---------------------------------------------------------------------------

class _QlPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis_points, parent_mask, parent_min, parent_max, offset):
        n = (parent_mask * (axis_points <= offset[..., None]).to(f32)).sum(-1)
        ctx.save_for_backward(axis_points, parent_mask, parent_min, parent_max, offset, n)
        return n

    @staticmethod
    def backward(ctx, upstream):
        axis_points, parent_mask, parent_min, parent_max, offset, n = ctx.saved_tensors
        # next discrete event: smallest masked point strictly right of offset
        right = parent_mask * (axis_points > offset[..., None]).to(f32)
        offset_above = common.masked_min(axis_points, right, -1)
        n1 = (parent_mask * (axis_points <= offset_above[..., None]).to(f32)).sum(-1)
        has_event = offset_above < BIG
        slope = torch.where(has_event,
                            (n1 - n) / torch.clamp(offset_above - offset, min=1e-12), 0.0)
        slope = torch.clamp(slope, 0.0, _GRAD_CLIP)
        return None, None, None, None, _in_node(upstream * slope, offset, parent_min, parent_max)


def ql_points(axis_points, parent_mask, parent_min, parent_max, offset):
    """N_left = sum(mask * [x <= offset]) with a step-function gradient wrt
    offset. axis_points (..., N); offset (...,)."""
    return _QlPoints.apply(axis_points, parent_mask, parent_min, parent_max, offset)


class _QlPrims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mids, parent_mask, parent_min, parent_max, offset):
        n = (parent_mask * (mids <= offset[..., None]).to(f32)).sum(-1)
        ctx.save_for_backward(mids, parent_mask, parent_min, parent_max, offset)
        return n

    @staticmethod
    def backward(ctx, upstream):
        mids, parent_mask, parent_min, parent_max, offset = ctx.saved_tensors
        right = parent_mask * (mids > offset[..., None]).to(f32)
        offset_above = common.masked_min(mids, right, -1)
        inc = (right * (mids == offset_above[..., None]).to(f32)).sum(-1)
        inc = torch.clamp(inc, min=1.0)
        has_event = offset_above < BIG
        slope = torch.where(has_event, inc / torch.clamp(offset_above - offset, min=1e-12), 0.0)
        slope = torch.clamp(slope, 0.0, _GRAD_CLIP)
        return None, None, None, None, _in_node(upstream * slope, offset, parent_min, parent_max)


def ql_prims(mids, parent_mask, parent_min, parent_max, offset):
    """N_left by midpoint classification. mids (..., N); offset (...,)."""
    return _QlPrims.apply(mids, parent_mask, parent_min, parent_max, offset)


# ---------------------------------------------------------------------------
# EPO child bounds: offset -> tight child plane bound with event gradients
# ---------------------------------------------------------------------------

def _min_max_mid(axis_points):
    mins = torch.amin(axis_points, -1)
    maxs = torch.amax(axis_points, -1)
    return mins, maxs, 0.5 * (mins + maxs)


def _safe_div(num, den):
    """num / den with |den| < 1e-12 replaced by 1e-12, as the JAX package."""
    return num / torch.where(den.abs() < 1e-12, 1e-12, den)


class _LeftChildBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis_points, parent_mask, parent_min, parent_max, offset):
        _, maxs, mids = _min_max_mid(axis_points)
        left = parent_mask * (offset[..., None] >= mids).to(f32)
        bound = torch.maximum(common.masked_max(maxs, left, -1), parent_min)
        ctx.save_for_backward(axis_points, parent_mask, parent_min, parent_max, offset, bound)
        return bound

    @staticmethod
    def backward(ctx, upstream):
        axis_points, parent_mask, parent_min, parent_max, offset, bound = ctx.saved_tensors
        _, maxs, mids = _min_max_mid(axis_points)
        # next event: the prim with the smallest mid strictly right of the
        # current left-child plane; moving offset there pulls its max in
        right = parent_mask * (bound[..., None] < mids).to(f32)
        offset_above = common.masked_min(mids, right, -1)
        at_event = right * (mids == offset_above[..., None]).to(f32)
        bound_above = common.masked_max(maxs, at_event, -1)
        has_event = offset_above < BIG
        slope = torch.where(has_event, _safe_div(bound_above - bound, offset_above - offset), 0.0)
        slope = torch.clamp(slope, 0.0, _GRAD_CLIP)
        return None, None, None, None, _in_node(upstream * slope, offset, parent_min, parent_max)


def left_child_bound(axis_points, parent_mask, parent_min, parent_max, offset):
    """Max bound of the left child: the max over prim maxes of the prims whose
    mid is left of offset. axis_points (..., N, 3 verts); offset (...,) ->
    bound (...,)."""
    return _LeftChildBound.apply(axis_points, parent_mask, parent_min, parent_max, offset)


class _RightChildBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis_points, parent_mask, parent_min, parent_max, offset):
        mins, _, mids = _min_max_mid(axis_points)
        right = parent_mask * (offset[..., None] < mids).to(f32)
        bound = torch.minimum(common.masked_min(mins, right, -1), parent_max)
        ctx.save_for_backward(axis_points, parent_mask, parent_min, parent_max, offset, bound)
        return bound

    @staticmethod
    def backward(ctx, upstream):
        axis_points, parent_mask, parent_min, parent_max, offset, bound = ctx.saved_tensors
        mins, _, mids = _min_max_mid(axis_points)
        # previous event: the prim with the largest mid left of the current
        # right bound; moving offset below it pushes the right-child min left
        left = parent_mask * (bound[..., None] >= mids).to(f32)
        offset_below = common.masked_max(mids, left, -1)
        at_event = left * (mids == offset_below[..., None]).to(f32)
        bound_below = common.masked_min(mins, at_event, -1)
        has_event = offset_below > -BIG
        # negative: a larger offset gives a larger right-child min bound
        slope = torch.where(has_event, -_safe_div(bound - bound_below, offset - offset_below),
                            0.0)
        slope = torch.clamp(slope, 0.0, _GRAD_CLIP)
        return None, None, None, None, _in_node(upstream * slope, offset, parent_min, parent_max)


def right_child_bound(axis_points, parent_mask, parent_min, parent_max, offset):
    """Min bound of the right child: the min over prim mins of the prims
    whose mid is right of offset."""
    return _RightChildBound.apply(axis_points, parent_mask, parent_min, parent_max, offset)


# ---------------------------------------------------------------------------
# soft_min: hard min forward, softmax(-t x) gradient
# ---------------------------------------------------------------------------

class _SoftMin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, t):
        ctx.save_for_backward(vals)
        ctx.t = t
        return torch.amin(vals, -1)

    @staticmethod
    def backward(ctx, upstream):
        (vals,) = ctx.saved_tensors
        x = -ctx.t * vals
        x = x - torch.amax(x, -1, keepdim=True)
        return upstream[..., None] * torch.softmax(x, -1), None


def soft_min(vals: torch.Tensor, t: float = 1.0) -> torch.Tensor:
    """vals (..., M) -> (...,) min with a temperature-t softmax backward."""
    return _SoftMin.apply(vals, t)


# ---------------------------------------------------------------------------
# EPO splitter: theta -> plane + children with refit bounds
# ---------------------------------------------------------------------------

def gen_nodes_epo(prims, bounds, thetas, node_mask):
    """gen_nodes_EPO over all 3 axes.

    prims (..., N, 9); bounds (..., 6); thetas (..., 3); node_mask (..., N).
    Returns (offsets (..., 3), off_left (..., 3), off_right (..., 3),
    child_bounds (..., 6, 6) ordered [xL xR yL yR zL zR]). The level bounds
    b0, b1 reach the result through clip and cat alone, as in JAX: the
    child-bound Functions give them no gradient.
    """
    bmin = bounds[..., 0:3]
    bmax = bounds[..., 3:6]
    offsets = bmin + thetas * (bmax - bmin)
    children, off_l, off_r = [], [], []
    for a in range(3):
        ap = common.prim_axis_points(prims, a)
        b0, b1, off = bmin[..., a], bmax[..., a], offsets[..., a]
        ol = left_child_bound(ap, node_mask, b0, b1, off)
        orr = right_child_bound(ap, node_mask, b0, b1, off)
        children.append(torch.cat([bmin, _set(bmax, a, common.clip(ol, b0, b1))], -1))
        children.append(torch.cat([_set(bmin, a, common.clip(orr, b0, b1)), bmax], -1))
        off_l.append(ol)
        off_r.append(orr)
    return offsets, torch.stack(off_l, -1), torch.stack(off_r, -1), torch.stack(children, -2)


# ---------------------------------------------------------------------------
# wL_fn_EPO: differentiable overlapped surface area
# ---------------------------------------------------------------------------

def _epo_masks(prims, node_bounds, node_mask, parent_mask):
    """Prims intersecting the node (>= 1 vertex inside) but not belonging to
    it -> (isect_not_member, in_sibling, outside_sibling, pt_in)."""
    v = common.prim_vertices(prims)
    bmin = node_bounds[..., None, None, 0:3]
    bmax = node_bounds[..., None, None, 3:6]
    pt_in = ((v >= bmin) & (v <= bmax)).all(-1)  # (..., N, 3)
    any_in = pt_in.any(-1).to(f32)
    not_in_node = 1.0 - node_mask
    isect_not_member = any_in * not_in_node
    in_sibling = isect_not_member * (parent_mask * not_in_node)
    outside_sibling = isect_not_member - in_sibling
    return isect_not_member, in_sibling, outside_sibling, pt_in


class _WEpo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prims, node_bounds, node_mask, parent_mask, node_min, node_max, axis,
                is_left):
        isect, _, _, _ = _epo_masks(prims, node_bounds, node_mask, parent_mask)
        areas = common.prim_areas(prims)
        sa_isect = (areas * isect).sum(-1)
        sa_total = torch.clamp(areas.sum(-1), min=1e-12)
        ctx.save_for_backward(prims, node_bounds, node_mask, parent_mask, node_min, node_max)
        ctx.axis, ctx.is_left = axis, is_left
        return 0.5 * sa_isect / sa_total

    @staticmethod
    def backward(ctx, upstream):
        prims, node_bounds, node_mask, parent_mask, node_min, node_max = ctx.saved_tensors
        axis, is_left = ctx.axis, ctx.is_left
        isect, in_sibling, outside_sibling, pt_in = _epo_masks(prims, node_bounds, node_mask,
                                                               parent_mask)
        ap = common.prim_axis_points(prims, axis)
        areas = common.prim_areas(prims)
        if is_left:
            # which intersecting prim's min is next to leave as node_max shrinks
            mins_inside = torch.amin(torch.where(pt_in, ap, BIG), -1)
            prim_ref = torch.where(in_sibling > 0, torch.amin(ap, -1),
                                   torch.where(outside_sibling > 0, mins_inside, -BIG))
            event_coord = common.masked_max(prim_ref, isect, -1)
            at_event = isect * (prim_ref == event_coord[..., None]).to(f32)
            numer = (areas * at_event).sum(-1) * 0.5
            denom = node_max - event_coord
        else:
            maxs_inside = torch.amax(torch.where(pt_in, ap, -BIG), -1)
            prim_ref = torch.where(in_sibling > 0, torch.amax(ap, -1),
                                   torch.where(outside_sibling > 0, maxs_inside, BIG))
            event_coord = common.masked_min(prim_ref, isect, -1)
            at_event = isect * (prim_ref == event_coord[..., None]).to(f32)
            numer = -(areas * at_event).sum(-1) * 0.5
            denom = event_coord - node_min
        sa_total = torch.clamp(areas.sum(-1), min=1e-12)
        slope = torch.where(denom.abs() > 1e-12, _safe_div(numer, denom), 0.0) / sa_total
        slope = torch.clamp(slope, 0.0, _GRAD_CLIP)
        g = upstream * slope
        zero = torch.zeros_like(g)
        return (None, None, None, None, zero if is_left else g, g if is_left else zero,
                None, None)


def w_epo(prims, node_bounds, node_mask, parent_mask, node_min, node_max, axis: int,
          is_left: bool):
    """EPO weight of a node: 0.5 * SA(prims intersecting the node from
    outside) / SA(all prims). Gradient wrt node_min (right child) / node_max
    (left child): the surface of the next primitive to stop intersecting over
    the distance to that event, clipped to [0, 1e4]."""
    return _WEpo.apply(prims, node_bounds, node_mask, parent_mask, node_min, node_max, axis,
                       is_left)
