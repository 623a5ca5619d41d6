"""Declarative FPN node-graph generators (BiFPN / PAN / Quad-FPN).

A feature-pyramid network is described as a DAG: the first ``num_levels``
node ids are the backbone features (P_min..P_max), and every subsequent
node consumes earlier nodes (``inputs_offsets``) and produces a feature map
at ``reduction`` (the total stride w.r.t. the input image).

Capability parity with the reference graph builders
(``effdet/config/fpn_config.py:6-184``), re-derived from the published BiFPN
(arXiv:1911.09070), PANet (arXiv:1803.01534) and Quad-FPN layouts. These are
pure functions of (min_level, max_level) returning plain tuples.

A copy of ``ood_object_detection_tpu.config.fpn_config`` (pure data, no
framework), kept here so the PyTorch port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class FpnNode:
    """One combine node in the FPN graph."""
    reduction: int                      # total stride of this node's output
    inputs_offsets: Tuple[int, ...]     # node ids this node consumes
    weight_method: str                  # 'sum' | 'attn' | 'fastattn'


@dataclasses.dataclass(frozen=True)
class FpnGraph:
    nodes: Tuple[FpnNode, ...]


def bifpn_graph(min_level: int, max_level: int, weight_method: str = "fastattn") -> FpnGraph:
    """Bidirectional FPN: one top-down pass then one bottom-up pass.

    Top-down nodes run from (max_level-1) down to min_level, each fusing the
    same-level backbone feature with the node one level coarser. Bottom-up
    nodes run from (min_level+1) to max_level, each fusing *all* previous
    same-level nodes with the node one level finer.
    """
    num_levels = max_level - min_level + 1
    node_ids: Dict[int, List[int]] = {min_level + i: [i] for i in range(num_levels)}
    next_id = itertools.count(num_levels)

    nodes: List[FpnNode] = []
    for lvl in range(max_level - 1, min_level - 1, -1):   # top-down
        nodes.append(FpnNode(
            reduction=1 << lvl,
            inputs_offsets=(node_ids[lvl][-1], node_ids[lvl + 1][-1]),
            weight_method=weight_method))
        node_ids[lvl].append(next(next_id))

    for lvl in range(min_level + 1, max_level + 1):       # bottom-up
        nodes.append(FpnNode(
            reduction=1 << lvl,
            inputs_offsets=tuple(node_ids[lvl]) + (node_ids[lvl - 1][-1],),
            weight_method=weight_method))
        node_ids[lvl].append(next(next_id))

    return FpnGraph(nodes=tuple(nodes))


def pan_graph(min_level: int, max_level: int, weight_method: str = "fastattn") -> FpnGraph:
    """PAN-style layout: full top-down chain then full bottom-up chain."""
    num_levels = max_level - min_level + 1
    node_ids: Dict[int, List[int]] = {min_level + i: [i] for i in range(num_levels)}
    next_id = itertools.count(num_levels)

    nodes: List[FpnNode] = []
    for lvl in range(max_level, min_level - 1, -1):
        if lvl == max_level:
            offsets = (node_ids[lvl][-1],)
        else:
            offsets = (node_ids[lvl][-1], node_ids[lvl + 1][-1])
        nodes.append(FpnNode(1 << lvl, offsets, weight_method))
        node_ids[lvl].append(next(next_id))

    for lvl in range(min_level, max_level + 1):
        if lvl == min_level:
            offsets = (node_ids[lvl][-1],)
        else:
            offsets = (node_ids[lvl][-1], node_ids[lvl - 1][-1])
        nodes.append(FpnNode(1 << lvl, offsets, weight_method))
        node_ids[lvl].append(next(next_id))

    return FpnGraph(nodes=tuple(nodes))


def qufpn_graph(min_level: int, max_level: int, weight_method: str = "fastattn") -> FpnGraph:
    """Quad-FPN: (top-down -> bottom-up) + (bottom-up -> top-down) + quad-add.

    Output order of the final quad-add nodes matches backbone ordering
    (increasing reduction) so a cell's output can feed the next repeat.
    """
    quad_method = "fastattn"
    num_levels = max_level - min_level + 1
    node_ids: Dict[int, List[int]] = {min_level + i: [i] for i in range(num_levels)}
    next_id = itertools.count(num_levels)
    nodes: List[FpnNode] = []

    # path 1: top-down
    for lvl in range(max_level - 1, min_level - 1, -1):
        nodes.append(FpnNode(
            1 << lvl, (node_ids[lvl][-1], node_ids[lvl + 1][-1]), weight_method))
        node_ids[lvl].append(next(next_id))
    node_ids[max_level].append(node_ids[max_level][-1])

    # path 2: bottom-up
    for lvl in range(min_level + 1, max_level):
        nodes.append(FpnNode(
            1 << lvl, tuple(node_ids[lvl]) + (node_ids[lvl - 1][-1],), weight_method))
        node_ids[lvl].append(next(next_id))
    lvl = max_level
    nodes.append(FpnNode(
        1 << lvl, (node_ids[lvl][0], node_ids[lvl - 1][-1]), weight_method))
    node_ids[lvl].append(next(next_id))
    node_ids[min_level].append(node_ids[min_level][-1])

    # path 3: second bottom-up (from raw backbone features)
    for lvl in range(min_level + 1, max_level + 1):
        prev = node_ids[lvl - 1][-1] if lvl != min_level + 1 else node_ids[lvl - 1][0]
        nodes.append(FpnNode(1 << lvl, (node_ids[lvl][0], prev), weight_method))
        node_ids[lvl].append(next(next_id))
    node_ids[min_level].append(node_ids[min_level][-1])

    # path 4: second top-down
    for lvl in range(max_level - 1, min_level, -1):
        nodes.append(FpnNode(
            1 << lvl,
            (node_ids[lvl][0], node_ids[lvl][-1], node_ids[lvl + 1][-1]),
            weight_method))
        node_ids[lvl].append(next(next_id))
    lvl = min_level
    nodes.append(FpnNode(
        1 << lvl, (node_ids[lvl][0], node_ids[lvl + 1][-1]), weight_method))
    node_ids[lvl].append(next(next_id))
    node_ids[max_level].append(node_ids[max_level][-1])

    # quad-add: merge ends of both double-paths, in increasing-reduction order
    for lvl in range(min_level, max_level + 1):
        nodes.append(FpnNode(
            1 << lvl, (node_ids[lvl][2], node_ids[lvl][4]), quad_method))
        node_ids[lvl].append(next(next_id))

    return FpnGraph(nodes=tuple(nodes))


_FPN_BUILDERS = {
    "bifpn_sum": (bifpn_graph, "sum"),
    "bifpn_attn": (bifpn_graph, "attn"),
    "bifpn_fa": (bifpn_graph, "fastattn"),
    "pan_sum": (pan_graph, "sum"),
    "pan_fa": (pan_graph, "fastattn"),
    "qufpn_sum": (qufpn_graph, "sum"),
    "qufpn_fa": (qufpn_graph, "fastattn"),
}


def get_fpn_config(fpn_name: str | None, min_level: int = 3, max_level: int = 7) -> FpnGraph:
    name = fpn_name or "bifpn_fa"
    builder, method = _FPN_BUILDERS[name]
    return builder(min_level=min_level, max_level=max_level, weight_method=method)
