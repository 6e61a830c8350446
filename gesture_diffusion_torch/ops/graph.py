"""Skeleton graph adjacency construction for ST-GCN style decoders.

Copy of ``gesture_diffusion_tpu/ops/graph.py`` (numpy only; copied, not
imported, because importing the JAX package's ``ops`` reaches JAX):
hop-distance adjacency, symmetric degree normalisation, and the uniform /
distance / spatial partition strategies.  Edge lists are numeric facts
about each mocap layout; the 75-node ``beat`` list mirrors the
reference's ``link_beat`` table.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# fmt: off
_BEAT_LINKS: List[Tuple[int, int]] = [
    (0, 1), (0, 63), (0, 69), (1, 2), (2, 3), (3, 4), (4, 5), (4, 9), (4, 36),
    (5, 6), (6, 7), (7, 8), (9, 10), (10, 11), (11, 12), (12, 13), (12, 17),
    (12, 27), (13, 14), (14, 15), (15, 16), (17, 18), (17, 22), (18, 19),
    (19, 20), (20, 21), (22, 23), (23, 24), (24, 25), (25, 26), (27, 28),
    (27, 32), (28, 29), (29, 30), (30, 31), (32, 33), (33, 34), (34, 35),
    (36, 37), (37, 38), (38, 39), (39, 40), (39, 44), (39, 54), (40, 41),
    (41, 42), (42, 43), (44, 45), (44, 49), (45, 46), (46, 47), (47, 48),
    (49, 50), (50, 51), (51, 52), (52, 53), (54, 55), (54, 59), (55, 56),
    (56, 57), (57, 58), (59, 60), (60, 61), (61, 62), (63, 64), (64, 65),
    (65, 66), (66, 67), (67, 68), (69, 70), (70, 71), (71, 72), (72, 73),
    (73, 74),
]

LAYOUTS: Dict[str, Tuple[int, List[Tuple[int, int]]]] = {
    "tp-vicon": (9, [(1, 0), (2, 1), (3, 2), (4, 3), (5, 0), (6, 5), (7, 6),
                     (8, 7)]),
    "hugadb": (6, [(1, 0), (2, 1), (3, 0), (4, 3), (5, 0)]),
    "lara": (19, [(1, 0), (2, 1), (3, 2), (4, 3), (5, 0), (6, 5), (7, 6),
                  (8, 7), (9, 0), (10, 9), (11, 9), (12, 10), (13, 12),
                  (14, 13), (15, 9), (16, 15), (17, 16), (18, 17)]),
    "pku-mmd": (25, [(12, 0), (13, 12), (14, 13), (15, 14), (16, 0), (17, 16),
                     (18, 17), (19, 18), (1, 0), (20, 1), (2, 20), (3, 2),
                     (4, 20), (5, 4), (6, 5), (7, 6), (21, 7), (22, 6),
                     (8, 20), (9, 8), (10, 9), (11, 10), (24, 10), (23, 11)]),
    "beat": (75, _BEAT_LINKS),
}
# fmt: on


def hop_distance(num_node: int, edges: List[Tuple[int, int]],
                 max_hop: int = 1) -> np.ndarray:
    adj = np.zeros((num_node, num_node))
    for i, j in edges:
        adj[i, j] = adj[j, i] = 1.0
    dist = np.full((num_node, num_node), np.inf)
    reach = np.stack([np.linalg.matrix_power(adj, d) > 0
                      for d in range(max_hop + 1)])
    for d in range(max_hop, -1, -1):
        dist[reach[d]] = d
    return dist


def normalize_undigraph(adj: np.ndarray) -> np.ndarray:
    deg = adj.sum(axis=0)
    inv_sqrt = np.where(deg > 0, deg ** -0.5, 0.0)
    return (inv_sqrt[:, None] * adj) * inv_sqrt[None, :]


def build_graph(layout: str = "beat", strategy: str = "spatial",
                max_hop: int = 1, dilation: int = 1,
                center: int = 0) -> np.ndarray:
    """:return: (K, V, V) partitioned, normalised adjacency stack."""
    if layout not in LAYOUTS:
        raise ValueError(f"Unknown graph layout: {layout}")
    num_node, neighbor = LAYOUTS[layout]
    edges = [(i, i) for i in range(num_node)] + list(neighbor)
    dist = hop_distance(num_node, edges, max_hop)
    valid_hops = range(0, max_hop + 1, dilation)

    adjacency = np.zeros((num_node, num_node))
    for hop in valid_hops:
        adjacency[dist == hop] = 1.0
    norm = normalize_undigraph(adjacency)

    if strategy == "uniform":
        return norm[None]
    if strategy == "distance":
        parts = []
        for hop in valid_hops:
            a = np.where(dist == hop, norm, 0.0)
            parts.append(a)
        return np.stack(parts)
    if strategy == "spatial":
        # all arrays indexed [j, i]; dc[x] = hop distance of node x to center
        dc = dist[:, center]
        d_j, d_i = dc[:, None], dc[None, :]
        parts = []
        for hop in valid_hops:
            mask = dist == hop
            a_root = np.where(mask & (d_j == d_i), norm, 0.0)
            a_close = np.where(mask & (d_j > d_i), norm, 0.0)
            a_further = np.where(mask & (d_j < d_i), norm, 0.0)
            if hop == 0:
                parts.append(a_root)
            else:
                parts.append(a_root + a_close)
                parts.append(a_further)
        return np.stack(parts)
    raise ValueError(f"Unknown partition strategy: {strategy}")
