"""Ontology reasoning support: rdfs:subClassOf hierarchies.

* **plan time, host**: closure sets (sorted id arrays) by BFS, consumed by
  ``filter_in`` and by KB pruning;
* **plan time, device**: the class hierarchy as a dense 0/1 adjacency
  matrix closed by repeated squaring — :mod:`repro_torch.kernels.closure`
  runs those squarings (and the fused descendants step) as CUDA kernels.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .kb import KnowledgeBase, host_rows


def subclass_edges(kb: KnowledgeBase, subclass_pred: int) -> List[Tuple[int, int]]:
    rows = host_rows(kb)
    m = rows[:, 1] == np.uint32(subclass_pred)
    return [(int(s), int(o)) for s, _, o in rows[m]]


def descendants(
    edges: Sequence[Tuple[int, int]], root: int, include_root: bool = True
) -> np.ndarray:
    """All classes c with c rdfs:subClassOf* root — sorted uint32 ids."""
    children: Dict[int, List[int]] = defaultdict(list)
    for child, parent in edges:
        children[parent].append(child)
    seen: Set[int] = {root} if include_root else set()
    frontier = [root]
    while frontier:
        nxt = []
        for node in frontier:
            for ch in children.get(node, ()):  # DAG-safe BFS
                if ch not in seen:
                    seen.add(ch)
                    nxt.append(ch)
        frontier = nxt
    return np.asarray(sorted(seen), np.uint32)


def build_class_index(edges: Sequence[Tuple[int, int]]) -> Tuple[Dict[int, int], np.ndarray]:
    """Dense index for class ids appearing in subclass edges."""
    ids = sorted({x for e in edges for x in e})
    idx = {cid: i for i, cid in enumerate(ids)}
    return idx, np.asarray(ids, np.uint32)


def adjacency_from_edges(
    edges: Sequence[Tuple[int, int]], idx: Dict[int, int]
) -> np.ndarray:
    n = len(idx)
    adj = np.zeros((max(n, 1), max(n, 1)), np.float32)
    for child, parent in edges:
        adj[idx[child], idx[parent]] = 1.0
    return adj
