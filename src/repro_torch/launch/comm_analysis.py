"""Collective-byte accounting of the port's exchanges between workers.

The counterpart of ``repro.launch.hlo_analysis``.  The reference sums
the output bytes of every collective in a compiled HLO module, since
``cost_analysis`` has no collective term.  Torch has no HLO, so the port
counts its own exchanges instead: every exchange between workers
(``launch.mesh.Grid``'s and ``InstanceMesh``'s, and the page exchange of
``core.kv_transform.migrate_sharded``) adds the bytes it moves to one
tally, by the reference's kinds.

A byte counts once for each worker that receives it from another
worker: an all-gather of a b-byte piece over n workers adds ``n*(n-1)*b``
(each worker receives the other n-1 pieces), an all-reduce of b bytes
``2*(n-1)*b`` (a ring's traffic: the port sums on one worker of the group
and copies the sum back), a reduce-scatter (the gradient of an
all-gather, summed back into each owner's shard) ``n*(n-1)*b``.  What a
worker keeps of its own is not counted.  The numbers are the grid's
total; divide by the workers for a per-device figure (the reference's
HLO numbers are per device and count an output's local part too).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class Tally:
    """Bytes by collective kind and the number of exchanges."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.count = 0

    def add(self, kind: str, nbytes: int) -> None:
        """One exchange of ``kind`` that moved ``nbytes`` between
        workers (an exchange that moved nothing still counts as one)."""
        self.bytes[kind] += int(nbytes)
        self.count += 1

    def collective_bytes(self) -> Dict[str, int]:
        """The reference's ``collective_bytes`` dict: a byte count per
        kind and ``count``."""
        return dict(self.bytes, count=self.count)


#: the tally every exchange of the port reports to
TALLY = Tally()


def collective_bytes() -> Dict[str, int]:
    """``TALLY``'s bytes by kind and its count, as the reference's
    ``collective_bytes`` returns them."""
    return TALLY.collective_bytes()


def total_collective_bytes(d: Dict[str, int] = None) -> int:
    """Every kind's bytes summed (``count`` left out) of ``d``, by
    default ``TALLY``'s."""
    d = collective_bytes() if d is None else d
    return sum(v for k, v in d.items() if k != "count")


@contextlib.contextmanager
def counting() -> Iterator[Tally]:
    """``TALLY`` reset on entry; yields it, to be read after the
    block."""
    TALLY.reset()
    yield TALLY
