"""Party-axis backends of the protocol programs.

Counterpart of ``honeybadgermpc_tpu/parallel/mesh.py``. So far only the
single-device simulation backend exists: all n parties live on one device
and the party axis is a leading batch axis of every share tensor, so the
reference's per-message sends become transposes and broadcasts. The mesh
and multi-host backends (``MeshBackend``, ``HybridBackend``, over
``torch.distributed``) are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.fparray import FpArray
from ..ops.limbs import L


class SimBackend:
    """All n parties simulated on one device: the party axis is axis 0 of
    every element shape."""

    def __init__(self, n: int):
        self.n = n

    def my_ids(self, device=torch.device("cuda")):
        """int32[n] party ids, for id-dependent protocol steps."""
        return torch.arange(self.n, dtype=torch.int32, device=device)

    def all_to_all(self, x: FpArray) -> FpArray:
        """x[party, ..., n] -> out[party, ..., n] with out[j, ..., i] =
        x[i, ..., j] (the R1 column transpose), contiguous."""
        return FpArray(x.limbs.transpose(1, x.limbs.dim() - 1).contiguous())

    def all_gather(self, x: FpArray) -> FpArray:
        """x[party, ...] -> out[party, ..., n]: every party's value,
        replicated to all parties on a new trailing axis (contiguous)."""
        limbs = x.limbs.movedim(1, -1)                  # [L, ..., n]
        return FpArray(limbs[:, None].expand(
            (L, self.n) + tuple(limbs.shape[1:])).contiguous())

    def broadcast_from(self, x: FpArray, src: int) -> FpArray:
        """Every party receives party src's value (party axis kept)."""
        limbs = x.limbs[:, src:src + 1]
        return FpArray(limbs.expand((L, self.n) + tuple(limbs.shape[2:])))
