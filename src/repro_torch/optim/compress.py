"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``).

The data-parallel mean of gradients goes over the wire as int8: each
leaf is quantised against a scale every entry of the reduce domain
agrees on, the codes are summed in int32 and dequantised, and the
quantisation residual is added to the next step's gradient (error
feedback keeps the scheme unbiased over time).  The wire cost of the
gradient all-reduce drops 4x against float32.

The reference runs inside ``shard_map`` over axis names, one program an
entry.  The port is single-controller: ``compressed_psum_mean`` takes
one gradient tree and one error tree for each entry of the reduce
domain, in mesh order (each on its entry's device), and returns each
entry's mean and new error, with the reference's arithmetic in its
order: the scale is the sum of the entries' maxima (summed in entry
order) over 127, the codes are rounded (half to even) and clipped to
int8, summed in int32, and times the scale over the entry count.

    means, errs = compressed_psum_mean(grads_per_entry, errs_per_entry)
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def compressed_psum_mean(grads: Sequence[Any], errs: Sequence[Any]
                         ) -> Tuple[List[Any], List[Any]]:
    """Mean-reduce the entries' gradient trees ``grads`` in int8, with
    each entry's error-feedback tree ``errs`` (float32, same structure)
    -> (each entry's mean tree, each entry's new error tree)."""
    if len(grads) != len(errs) or not grads:
        raise ValueError(f"{len(grads)} gradient trees and {len(errs)} "
                         f"error trees: want one of each an entry")
    world = float(len(grads))
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in errs]
    means = [[] for _ in grads]
    new_errs = [[] for _ in grads]
    for leaf in range(len(flat_g[0])):
        g = [fg[leaf].float() + fe[leaf] for fg, fe in zip(flat_g, flat_e)]
        home = g[0].device
        # a scale every entry agrees on: the sum of the entries' maxima
        # bounds every entry's |g|
        m = torch.amax(torch.abs(g[0]))
        for gi in g[1:]:
            m = m + torch.amax(torch.abs(gi)).to(home)
        scale = torch.clamp(m, min=1e-30) / 127.0
        total = None
        for i, gi in enumerate(g):
            sc = scale.to(gi.device)
            q = torch.clamp(torch.round(gi / sc), -127, 127).to(torch.int8)
            new_errs[i].append(gi - q.float() * sc)
            qi = q.to(torch.int32).to(home)
            total = qi if total is None else total + qi
        mean = total.float() * scale / world
        for i, gi in enumerate(g):
            means[i].append(mean.to(gi.device))
    return ([_rebuild(t, m) for t, m in zip(grads, means)],
            [_rebuild(t, e) for t, e in zip(grads, new_errs)])


def _rebuild(tree: Any, leaves: List[torch.Tensor]) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_error_state(grads_template: Any) -> Any:
    """Zero float32 error state of the template's shapes and devices."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)
