"""Static Medusa tree/chain buffers — the port's own copy of
whisper_medusa_tpu/decoding/buffers.py (numpy only).

Re-derivation of the reference's ``generate_medusa_buffers``
(reference: whisper_medusa/models/medusa_utils.py:305-421) as host-side numpy arrays,
computed once per ``medusa_choices`` and read by the decode loop.

``medusa_choices`` is a list of per-level branching factors (level 0 = base head,
level i = medusa head i).  The default all-ones config makes the tree a single chain.
Unlike the reference — which builds a tree attention mask but never wires it into the
verification forward (SURVEY §2 component 11: dead buffers) — this implementation
feeds the ancestor mask into the decoder so branching trees verify *correctly*.

Buffer semantics:
  * ``tree_indices[n]``   — index into the flat per-level top-k candidate list for
                            tree node n (nodes are laid out level by level).
  * ``position_ids[n]``   — depth of node n (0-based level == relative position).
  * ``attn_mask[i, j]``   — True iff node j is node i or an ancestor of node i.
  * ``retrieve_indices``  — (num_paths, num_levels) tree-node index of each level
                            along every root-to-leaf cartesian path, in
                            ``itertools.product`` (mixed-radix, last digit fastest)
                            order — matching ``torch.cartesian_prod``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MedusaBuffers:
    choices: Tuple[int, ...]
    tree_indices: np.ndarray      # (num_nodes,) int32
    position_ids: np.ndarray      # (num_nodes,) int32
    attn_mask: np.ndarray         # (num_nodes, num_nodes) bool
    retrieve_indices: np.ndarray  # (num_paths, num_levels) int32

    @property
    def num_nodes(self) -> int:
        return int(self.tree_indices.shape[0])

    @property
    def num_paths(self) -> int:
        return int(self.retrieve_indices.shape[0])

    @property
    def num_levels(self) -> int:
        return int(self.retrieve_indices.shape[1])

    @property
    def is_chain(self) -> bool:
        return all(c == 1 for c in self.choices)


def generate_medusa_buffers(choices: Sequence[int]) -> MedusaBuffers:
    choices = tuple(int(c) for c in choices)
    if len(choices) == 0 or any(c < 1 for c in choices):
        raise ValueError(f"medusa_choices must be positive ints, got {choices}")
    if choices[0] != 1:
        # The base level is greedy: the reference takes argmax of the base logits
        # only (medusa_utils.py:444-446).
        raise ValueError("medusa_choices[0] must be 1 (greedy base head)")

    num_levels = len(choices)
    level_sizes = np.cumprod(choices)            # nodes per level
    level_starts = np.concatenate([[0], np.cumsum(level_sizes)])  # node-index offsets
    flat_starts = np.concatenate([[0], np.cumsum(choices)])       # flat-candidate offsets
    num_nodes = int(level_sizes.sum())

    tree_indices = np.zeros((num_nodes,), np.int32)
    position_ids = np.zeros((num_nodes,), np.int32)
    parent = np.full((num_nodes,), -1, np.int32)

    for lvl in range(num_levels):
        n_parents = 1 if lvl == 0 else int(level_sizes[lvl - 1])
        for p in range(n_parents):
            for j in range(choices[lvl]):
                node = int(level_starts[lvl]) + p * choices[lvl] + j
                tree_indices[node] = flat_starts[lvl] + j
                position_ids[node] = lvl
                if lvl > 0:
                    parent[node] = int(level_starts[lvl - 1]) + p

    attn_mask = np.zeros((num_nodes, num_nodes), np.bool_)
    for n in range(num_nodes):
        m = n
        while m != -1:
            attn_mask[n, m] = True
            m = int(parent[m])

    # Cartesian paths in mixed-radix order (last level fastest) -> node index per level.
    num_paths = int(np.prod(choices))
    retrieve = np.zeros((num_paths, num_levels), np.int32)
    for path in range(num_paths):
        digits = []
        rem = path
        for lvl in reversed(range(num_levels)):
            digits.append(rem % choices[lvl])
            rem //= choices[lvl]
        digits = digits[::-1]
        node = 0  # level-0 node index within level
        for lvl in range(num_levels):
            node = node * choices[lvl] + digits[lvl]
            retrieve[path, lvl] = level_starts[lvl] + node
    return MedusaBuffers(
        choices=choices,
        tree_indices=tree_indices,
        position_ids=position_ids,
        attn_mask=attn_mask,
        retrieve_indices=retrieve,
    )
