"""Party-axis backends of the protocol programs.

Counterpart of ``honeybadgermpc_tpu/parallel/mesh.py``. So far only the
single-device simulation backend exists, and of it only what the fused
offline programs need: its identity (they are gated to it, see
runtime/offline.py) and the party count. Its collectives (all_to_all,
all_gather, broadcast_from) and the mesh and multi-host backends are not
ported yet.
"""

from __future__ import annotations


class SimBackend:
    """All n parties simulated on one device: the party axis is an axis of
    every share tensor."""

    def __init__(self, n: int):
        self.n = n
