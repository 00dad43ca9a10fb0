"""Generalized segment reductions (counterpart of ``spla_tpu/utils/segments.py``).

Two paths:

* **scatter path** — when the combine op coincides with a
  ``Tensor.scatter_reduce`` kind (sum, prod, amin, amax); float MIN / MAX
  fold integer keys in the values' order with -0.0 below +0.0, so that a
  fold's zero depends on neither the order of its entries nor the device
  (the rule of the ops' MIN / MAX and of the kernels' ``op_min`` /
  ``op_max``);
* **generic path** — for any other associative op (BOR, LOR, user ops, ...),
  a segmented inclusive scan over (value, has, segment-head) triples, with
  validity flags so that the op needs no identity.
"""

from __future__ import annotations

import torch

from .bits import cat, gather, where

__all__ = ["scalar_on", "segmented_scan_fold", "segment_fold", "combine_segments"]

_REDUCE = {"add": "sum", "mul": "prod", "min": "amin", "max": "amax"}
_FULL = {"add": torch.sum, "mul": torch.prod, "min": torch.amin, "max": torch.amax}


_KEY_DTYPES = {torch.float32: torch.int32, torch.float64: torch.int64}


def _flip(bits):
    """Signed integer bits of floats to and from order keys: a negative
    value's magnitude bits inverted (an involution)."""
    return bits ^ ((bits >> (8 * bits.element_size() - 1)) & torch.iinfo(bits.dtype).max)


def _order_keys(t):
    """Float ``t`` as signed integers in the order of its values, -0.0 just
    below +0.0 (IEEE 754-2019 ``minimum`` / ``maximum``, op.py ``_float_min``);
    a NaN gets a key that means nothing."""
    return _flip(t.view(_KEY_DTYPES[t.dtype]))


def _from_keys(keys, dtype):
    """The floats of ``_order_keys``' keys."""
    return _flip(keys).view(dtype)


def segmented_scan_fold(values, valid, heads, op):
    """Segmented inclusive fold with validity (Hillis-Steele, log2(k) steps).

    ``values`` [k] (garbage allowed where ~valid), ``valid`` [k] bool,
    ``heads`` [k] bool (True at each segment's first element), ``op`` an
    associative combine.  Returns ``(scan_values, scan_has)``: at the last
    position of each segment, the left-to-right fold over its valid
    elements and whether there was any."""
    v, h, f = values, valid, heads
    k = v.shape[0]
    d = 1
    while d < k:
        av, ah, af = v[:-d], h[:-d], f[:-d]
        bv, bh, bf = v[d:], h[d:], f[d:]
        merged = where(ah & bh, op(av, bv), where(bh, bv, av))
        v = cat([v[:d], where(bf, bv, merged)])
        h = torch.cat([h[:d], torch.where(bf, bh, ah | bh)])
        f = torch.cat([f[:d], af | bf])
        d *= 2
    return v, h


def scalar_on(value, dtype, device):
    """``value`` (a number, a tensor or a ``Scalar``) as a 0-d tensor of
    ``dtype`` on ``device``: a tensor there is converted, anything else
    fills a new one there.  No call copies from the host, which would wait
    for a CUDA stream."""
    value = value.value if hasattr(value, "value") else value
    if isinstance(value, torch.Tensor) and value.device == device:
        return value.to(dtype).reshape(())
    if hasattr(value, "item"):
        value = value.item()
    return torch.full((), value, dtype=dtype, device=device)


def combine_segments(values, has, init, op):
    """``op(init, values)`` where ``has``, else ``init`` (the reference's
    ``sum = init; sum = add(sum, ...)`` chain)."""
    init_b = scalar_on(init, values.dtype, values.device).expand(values.shape)
    return where(has, op(init_b, values), init_b)


def segment_fold(values, seg_ids, valid, num_segments, op, init, sorted_ids=True):
    """Fold ``values`` grouped by ``seg_ids`` into ``num_segments`` buckets.

    ``result[s] = op(init, fold(op, values of segment s))``; segments with
    no valid element get ``init``.  Also returns ``has`` (the segment had a
    valid element): a stored value may equal ``init``.  ``seg_ids`` lie in
    ``[0, num_segments]``, where ``num_segments`` is a dump slot.  The
    generic path needs ``seg_ids`` sorted unless ``sorted_ids=False``."""
    device = values.device
    init = scalar_on(init, values.dtype, device)

    scatter = getattr(op, "scatter", None)
    if scatter is not None:
        # f32 MIN / MAX fold order keys (``_order_keys``), so that -0.0 lies below +0.0 whatever
        # the order of the entries or the device's atomics; NaN, which keys do not order, is put
        # back by a pass of its own (it propagates, as in the ops' MIN / MAX and the JAX scatter)
        keyed = scatter in ("min", "max") and values.is_floating_point()
        if keyed:
            work, init_w = _order_keys(values), _order_keys(init)
        else:
            work = values.to(torch.int64) if values.dtype == torch.uint32 else values
            init_w = init.to(work.dtype)
        if num_segments == 1:
            # one segment: a tree reduction, whose f32 error grows with log k, not with k as a
            # chain of atomic adds to one address does (1.2e-5 of 2^17 sums on the H100)
            neutral = init_w if scatter in ("min", "max") else (1 if scatter == "mul" else 0)
            total = _FULL[scatter](torch.cat([init_w.reshape(1), torch.where(valid, work, neutral)]))
            out = total.to(work.dtype).reshape(1)
            if keyed:
                nan = torch.isnan(init) | (torch.isnan(values) & valid).any()
                out = torch.where(nan, torch.nan, _from_keys(out, values.dtype))
            elif values.dtype == torch.uint32:
                out = (out & 0xFFFFFFFF).to(torch.uint32)
            return out, valid.any().reshape(1)
        seg = torch.where(valid, seg_ids.long(), num_segments)
        neutral = 1 if scatter == "mul" else 0
        safe = torch.where(valid, work, neutral)
        out = init_w.expand(num_segments + 1).clone()
        out.scatter_reduce_(0, seg, safe, _REDUCE[scatter], include_self=True)
        if keyed:
            nan_seg = torch.isnan(init).expand(num_segments + 1).clone()
            nan_seg.index_fill_(0, torch.where(torch.isnan(values), seg, num_segments), True)
            out = torch.where(nan_seg, torch.nan, _from_keys(out, values.dtype))
        elif values.dtype == torch.uint32:
            out = (out & 0xFFFFFFFF).to(torch.uint32)
        has = torch.zeros(num_segments + 1, dtype=torch.bool, device=device)
        has.index_fill_(0, seg, True)
        return out[:num_segments], has[:num_segments]

    if not getattr(op, "associative", True):
        raise ValueError(f"op {getattr(op, 'name', op)} is not associative; "
                         "it cannot be a parallel reduction monoid")
    seg_ids = seg_ids.long()
    k = values.shape[0]
    if k == 0:
        return (init.expand(num_segments).clone(),
                torch.zeros(num_segments, dtype=torch.bool, device=device))
    if not sorted_ids:
        order = torch.argsort(seg_ids, stable=True)
        seg_ids, values, valid = seg_ids[order], gather(values, order), valid[order]
    heads = torch.ones(k, dtype=torch.bool, device=device)
    heads[1:] = seg_ids[1:] != seg_ids[:-1]
    scan_v, scan_h = segmented_scan_fold(values, valid, heads, op)
    seg_range = torch.arange(num_segments, dtype=seg_ids.dtype, device=device)
    ends = torch.searchsorted(seg_ids, seg_range, right=True)
    starts = torch.searchsorted(seg_ids, seg_range, right=False)
    last = torch.clamp(ends - 1, 0, k - 1)
    has = (ends > starts) & scan_h[last]
    folded = where(has, gather(scan_v, last), init)
    return combine_segments(folded, has, init, op).to(values.dtype), has
