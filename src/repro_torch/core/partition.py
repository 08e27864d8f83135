"""Pool-partition manager: one ledger for every device in the cluster.

Gyges borrows *whole* engines when a long request needs a wider pool
(Fig. 3); Infinite-LLM/DistAttention spills overflow KV pages into a
neighbor's pool instead; LoongServe loans a *fraction* of an engine's
devices while both sides keep serving.  All three moves mutate the same
underlying resource — which engine currently holds which device, and
whose page tables can reach which pages — so this module owns that
state as a single first-class object instead of the ad-hoc ``_loans``
dict + park/revive bookkeeping the control planes used to scatter.

Devices are opaque hashable tokens.  In the port they are worker
identities (``launch.mesh.Worker``: an index in the pool and a torch
device), never ``torch.device`` values: two workers on one card are two
entries of the ledger.  The manager never touches a device — it is pure
bookkeeping, a copy of ``repro.core.partition`` — which is what makes it
cheap enough to drive from a stateful fuzz harness at thousands of
action interleavings per second.

States a device can be in (the partition invariant, checked by
``check_invariants``):

  * held by exactly one SERVING partition (its owner, or a borrower
    holding it on loan), or
  * home to a PARKED partition whose entire width is out on loan
    (a whole-engine loan: the classic park/merge), or
  * in flight inside a loan record (lender already shed it, borrower
    not yet widened) — still reachable from exactly one loan.

Spill regions are tracked alongside: each records which engine hosts
which overflow pages for which request, and the invariant is that every
spilled page is reachable from exactly one (guest request, host) pair.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, Iterable, List, Optional, Tuple

Device = Hashable


class PartitionError(RuntimeError):
    """A ledger operation that would corrupt the partition invariant."""


@dataclass
class Loan:
    """Devices moved from ``lender`` to ``borrower``.

    ``whole=True`` is the classic full merge: the lender parked and its
    entire width moved.  ``whole=False`` is a partial loan: the lender
    shrank in place and keeps serving on its retained devices.
    ``adopted`` flips when the borrower has actually widened onto the
    devices (between shed and adopt they are "in flight")."""
    lender: int
    borrower: int
    devices: List[Device]
    whole: bool
    adopted: bool = False


@dataclass
class SpillRegion:
    """Overflow KV pages for request ``rid`` (served by ``guest``)
    hosted in ``host``'s pool."""
    guest: int
    host: int
    rid: int
    pages: int
    host_slots: Tuple[int, ...]
    meta: Dict[str, Any] = field(default_factory=dict)


class PoolPartitionManager:
    """Owner/loan/park/spill ledger for every device in the pool."""

    def __init__(self) -> None:
        # iid -> the devices this partition was registered with (its home
        # set; never mutated by loans)
        self._home: Dict[int, List[Device]] = {}
        # iid -> devices the partition currently HOLDS (home minus
        # lent-out, plus borrowed)
        self._held: Dict[int, List[Device]] = {}
        self._parked: Dict[int, bool] = {}
        self._loans: List[Loan] = []
        self._spills: Dict[int, SpillRegion] = {}
        self._next_region = 0

    # -- registration ---------------------------------------------------

    def register(self, iid: int, devices: Iterable[Device]) -> None:
        devs = list(devices)
        if iid in self._home:
            raise PartitionError(f"partition {iid} already registered")
        for d in devs:
            holder = self.holder_of(d)
            if holder is not None:
                raise PartitionError(
                    f"device {d!r} already held by partition {holder}")
        self._home[iid] = list(devs)
        self._held[iid] = list(devs)
        self._parked[iid] = False

    def partitions(self) -> List[int]:
        return sorted(self._home)

    def home_devices(self, iid: int) -> List[Device]:
        return list(self._home[iid])

    def held_devices(self, iid: int) -> List[Device]:
        return list(self._held[iid])

    def parked(self, iid: int) -> bool:
        return self._parked[iid]

    def holder_of(self, device: Device) -> Optional[int]:
        for iid, devs in self._held.items():
            if any(d is device or d == device for d in devs):
                return iid
        return None

    # -- loans ----------------------------------------------------------

    def lend(self, lender: int, borrower: int, devices: Iterable[Device],
             *, whole: bool) -> Loan:
        """Record ``devices`` moving lender -> borrower.  The devices
        leave the lender's held set immediately (the lender's shrink
        transform has shed them / is shedding them) and enter the
        borrower's held set when ``adopt`` is called."""
        devs = list(devices)
        if lender == borrower:
            raise PartitionError("a partition cannot lend to itself")
        held = self._held[lender]
        for d in devs:
            if d not in held:
                raise PartitionError(
                    f"partition {lender} does not hold device {d!r}")
        if whole and len(devs) != len(held):
            raise PartitionError(
                "whole-engine loan must move every held device")
        self._held[lender] = [d for d in held if d not in devs]
        loan = Loan(lender=lender, borrower=borrower, devices=devs,
                    whole=whole)
        self._loans.append(loan)
        return loan

    def adopt(self, borrower: int, loan: Loan) -> None:
        if loan.borrower != borrower or loan.adopted:
            raise PartitionError("loan is not adoptable by this borrower")
        loan.adopted = True
        self._held[borrower] = self._held[borrower] + list(loan.devices)

    def loans_to(self, borrower: int) -> List[Loan]:
        return [ln for ln in self._loans if ln.borrower == borrower]

    def loans_from(self, lender: int) -> List[Loan]:
        return [ln for ln in self._loans if ln.lender == lender]

    def return_loan(self, loan: Loan) -> List[Device]:
        """The borrower shed the devices (split transform landed); hand
        them back to the lender's held set and drop the record."""
        if loan not in self._loans:
            raise PartitionError("unknown loan")
        if loan.adopted:
            held = self._held[loan.borrower]
            gone = [d for d in loan.devices if d not in held]
            if gone:
                holders = sorted({str(self.holder_of(d)) for d in gone})
                raise PartitionError(
                    f"cannot return loan {loan.lender}->{loan.borrower}: "
                    f"{len(gone)} device(s) were re-loaned (currently "
                    f"held by partition(s) "
                    f"{', '.join(holders) or 'in-flight'}); return those "
                    f"loans first")
        self._loans.remove(loan)
        if loan.adopted:
            self._held[loan.borrower] = [
                d for d in self._held[loan.borrower]
                if d not in loan.devices]
        self._held[loan.lender] = (self._held[loan.lender]
                                   + list(loan.devices))
        return list(loan.devices)

    # -- park / revive ---------------------------------------------------

    def park(self, iid: int) -> None:
        if self._held[iid]:
            raise PartitionError(
                f"cannot park partition {iid}: it still holds "
                f"{len(self._held[iid])} device(s)")
        if self._parked[iid]:
            raise PartitionError(f"partition {iid} already parked")
        self._parked[iid] = True

    def revive(self, iid: int) -> None:
        """A parked partition comes back to serve on its full home set.
        Refuses — loudly — if any home device is still out on loan
        (e.g. fractionally re-loaned to a third engine before the
        revive), because reviving would put one device in two serving
        partitions."""
        if not self._parked[iid]:
            raise PartitionError(f"partition {iid} is not parked")
        held = self._held[iid]
        missing = [d for d in self._home[iid] if d not in held]
        if missing:
            holders = sorted({str(self.holder_of(d)) for d in missing})
            raise PartitionError(
                f"cannot revive partition {iid}: {len(missing)} of its "
                f"home device(s) are still loaned out (currently held "
                f"by partition(s) {', '.join(holders) or 'in-flight'}); "
                f"return the loans first")
        self._parked[iid] = False

    # -- spill regions ---------------------------------------------------

    def open_spill(self, guest: int, host: int, rid: int, pages: int,
                   host_slots: Iterable[int], **meta: Any) -> int:
        if guest == host:
            raise PartitionError("spill host must be a different engine")
        for region in self._spills.values():
            if region.rid == rid:
                raise PartitionError(
                    f"request {rid} already has an open spill region")
        region_id = self._next_region
        self._next_region += 1
        self._spills[region_id] = SpillRegion(
            guest=guest, host=host, rid=rid, pages=pages,
            host_slots=tuple(host_slots), meta=dict(meta))
        return region_id

    def close_spill(self, region_id: int) -> SpillRegion:
        if region_id not in self._spills:
            raise PartitionError(f"unknown spill region {region_id}")
        return self._spills.pop(region_id)

    def spills(self) -> Dict[int, SpillRegion]:
        return dict(self._spills)

    def spill_for(self, rid: int) -> Optional[Tuple[int, SpillRegion]]:
        for region_id, region in self._spills.items():
            if region.rid == rid:
                return region_id, region
        return None

    # -- invariants -------------------------------------------------------

    def check_invariants(self) -> None:
        """Every registered device is reachable exactly once; parked
        partitions hold nothing; loans reference live partitions;
        spilled pages are hosted by exactly one region per request."""
        seen: Dict[Device, str] = {}

        def _claim(d: Device, where: str) -> None:
            if d in seen:
                raise PartitionError(
                    f"device {d!r} reachable twice: {seen[d]} and {where}")
            seen[d] = where

        for iid, devs in self._held.items():
            if self._parked[iid] and devs:
                raise PartitionError(
                    f"parked partition {iid} holds {len(devs)} device(s)")
            for d in devs:
                _claim(d, f"held by {iid}")
        for ln in self._loans:
            if ln.lender not in self._home or ln.borrower not in self._home:
                raise PartitionError("loan references unknown partition")
            if not ln.adopted:
                for d in ln.devices:
                    _claim(d, f"in-flight loan {ln.lender}->{ln.borrower}")
        universe = {d for devs in self._home.values() for d in devs}
        missing = universe - set(seen)
        if missing:
            raise PartitionError(
                f"{len(missing)} device(s) unreachable from any serving "
                f"partition or loan: {sorted(map(str, missing))[:4]}")
        rids = [r.rid for r in self._spills.values()]
        if len(rids) != len(set(rids)):
            raise PartitionError(
                "a request's spilled pages are reachable from more than "
                "one region")
        for region in self._spills.values():
            if region.host not in self._home:
                raise PartitionError(
                    f"spill region hosts pages on unknown partition "
                    f"{region.host}")
            if region.pages <= 0 or not region.host_slots:
                raise PartitionError("degenerate spill region")

    # -- debugging --------------------------------------------------------

    def describe(self) -> str:
        lines = []
        for iid in self.partitions():
            state = "parked" if self._parked[iid] else "serving"
            lines.append(
                f"p{iid} [{state}] holds={len(self._held[iid])} "
                f"home={len(self._home[iid])}")
        for ln in self._loans:
            kind = "whole" if ln.whole else "partial"
            stage = "adopted" if ln.adopted else "in-flight"
            lines.append(
                f"loan {ln.lender}->{ln.borrower} x{len(ln.devices)} "
                f"({kind}, {stage})")
        for rid_, region in self._spills.items():
            lines.append(
                f"spill#{rid_} rid={region.rid} guest={region.guest} "
                f"host={region.host} pages={region.pages}")
        return "\n".join(lines) or "<empty>"
