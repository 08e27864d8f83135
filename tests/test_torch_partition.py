"""The port's pool-partition ledger (``repro_torch.core.partition``)
against the reference's, in the style of ``tests/test_partition_fuzz.py``.

Seeded random sequences of the ledger's transitions, in the control
plane's call patterns (full and partial merges, deferred adoption,
splits with the lender's revive, spill regions) and refused ones
(early revives, foreign or self loans, parks of a holding partition),
go to both managers.  After every operation both must give the same
result or the same ``PartitionError`` (a refusal changing nothing),
hold the same ledger, and pass ``check_invariants``.  One pool uses
the port's worker identities where several workers share one device
(the card's case: two workers of ``cpu`` are two entries), one plain
ints.
"""
import numpy as np
import pytest
import torch

from repro.core import partition as RP
from repro_torch.core import partition as TP
from repro_torch.launch.mesh import Worker, workers_of

N_SEQUENCES, N_STEPS = 200, 30


def _snapshot(pm):
    return (
        {i: tuple(pm.home_devices(i)) for i in pm.partitions()},
        {i: tuple(pm.held_devices(i)) for i in pm.partitions()},
        {i: pm.parked(i) for i in pm.partitions()},
        tuple((ln.lender, ln.borrower, tuple(ln.devices), ln.whole,
               ln.adopted)
              for i in pm.partitions() for ln in pm.loans_to(i)),
        tuple(sorted((rid, r.guest, r.host, r.rid, r.pages, r.host_slots)
                     for rid, r in pm.spills().items())),
        pm.describe(),
    )


def _loans(pm):
    return [ln for i in pm.partitions() for ln in pm.loans_to(i)]


def _live(m):
    return [x for x in m.partitions() if not m.parked(x)]


def _pick(xs, i):
    return xs[i % len(xs)] if xs else None


# -- transitions: the cluster's call patterns (``ClusterEngine._merge``,
#    ``_merge_partial``, ``_advance_partials``, ``_finalize_releases``)
#    and refused ones.  Each takes the manager and pre-drawn indices, so
#    both managers make the same choices from equal states.

def full_merge(m, i, j):
    donor = _pick([x for x in _live(m) if m.held_devices(x)
                   and not m.loans_from(x) and not m.loans_to(x)], i)
    borrower = _pick([x for x in _live(m) if x != donor], j)
    if donor is None or borrower is None:
        return None
    loan = m.lend(donor, borrower, m.held_devices(donor), whole=True)
    m.park(donor)
    m.adopt(borrower, loan)
    return loan


def partial_merge(m, i, j, k, defer=False):
    donor = _pick([x for x in _live(m) if len(m.held_devices(x)) >= 2], i)
    borrower = _pick([x for x in _live(m) if x != donor], j)
    if donor is None or borrower is None:
        return None
    held = m.held_devices(donor)
    loan = m.lend(donor, borrower, held[-(1 + k % (len(held) - 1)):],
                  whole=False)
    if not defer:
        m.adopt(borrower, loan)
    return loan


def adopt_pending(m, i):
    loan = _pick([ln for ln in _loans(m) if not ln.adopted], i)
    if loan is not None:
        m.adopt(loan.borrower, loan)
    return loan


def split(m, i):
    """Return one loan, then revive its lender once its home set is back
    (a return whose devices were re-lent is refused)."""
    loan = _pick(_loans(m), i)
    if loan is None:
        return None
    devs = m.return_loan(loan)
    if m.parked(loan.lender):
        held = m.held_devices(loan.lender)
        if all(d in held for d in m.home_devices(loan.lender)):
            m.revive(loan.lender)
    return devs


def revive_early(m, i):
    """Reviving a parked donor whose home devices are still out."""
    return m.revive(_pick(m.partitions(), i))


def lend_foreign(m, i, j, k):
    """Refused lends: a device no partition has, a self-loan, or a
    'whole' loan of part of the held devices."""
    a = _pick(m.partitions(), i)
    held = m.held_devices(a)
    if k % 3 == 0:
        return m.lend(a, (a + 1) % len(m.partitions()), ["foreign"],
                      whole=False)
    if k % 3 == 1 or len(held) < 2:
        return m.lend(a, a, held, whole=False)
    return m.lend(a, _pick([x for x in m.partitions() if x != a], j),
                  held[:1], whole=True)


def park_holding(m, i):
    """Refused parks: a partition that holds devices, or is parked."""
    x = _pick([x for x in m.partitions()
               if m.parked(x) or m.held_devices(x)], i)
    return None if x is None else m.park(x)


def spill(m, i, j, rid, close):
    if close and m.spills():
        return m.close_spill(_pick(sorted(m.spills()), i))
    return m.open_spill(_pick(m.partitions(), i), _pick(m.partitions(), j),
                        rid, 1 + rid % 3, tuple(range(1 + rid % 2)), note=rid)


def _op(rng):
    """One random transition as (name, callable on a manager)."""
    i, j, k, rid = (int(x) for x in rng.integers(0, 10 ** 6, size=4))
    kind = int(rng.integers(9))
    table = [("full_merge", lambda m: full_merge(m, i, j)),
             ("partial_merge", lambda m: partial_merge(m, i, j, k)),
             ("partial_deferred",
              lambda m: partial_merge(m, i, j, k, defer=True)),
             ("adopt_pending", lambda m: adopt_pending(m, i)),
             ("split", lambda m: split(m, i)),
             ("revive_early", lambda m: revive_early(m, i)),
             ("lend_foreign", lambda m: lend_foreign(m, i, j, k)),
             ("park_holding", lambda m: park_holding(m, i)),
             ("spill", lambda m: spill(m, i, j, rid % 5, k % 2))]
    return table[kind]


def _image(result):
    if isinstance(result, (RP.Loan, TP.Loan)):
        return ("loan", result.lender, result.borrower,
                tuple(result.devices), result.whole, result.adopted)
    if isinstance(result, (RP.SpillRegion, TP.SpillRegion)):
        return ("spill", result.guest, result.host, result.rid,
                result.pages, result.host_slots, tuple(result.meta.items()))
    return result


def _apply(m, fn):
    try:
        return _image(fn(m))
    except (RP.PartitionError, TP.PartitionError) as e:
        return ("error", str(e))


POOLS = {
    # two engines of two workers each, every worker on one device
    "shared-device": lambda: workers_of(["cpu"] * 4),
    "ints": lambda: list(range(6)),
}


@pytest.mark.parametrize("pool", list(POOLS))
def test_ledgers_agree_on_random_sequences(pool):
    rng = np.random.default_rng(11)
    n_errors = n_ok = 0
    for seq in range(N_SEQUENCES):
        devices = POOLS[pool]()
        per = 2 if pool == "shared-device" else int(rng.choice([1, 2, 3]))
        n_parts = len(devices) // per
        ref, port = RP.PoolPartitionManager(), TP.PoolPartitionManager()
        for m in (ref, port):
            for i in range(n_parts):
                m.register(i, devices[i * per:(i + 1) * per])
        for step in range(N_STEPS):
            name, fn = _op(rng)
            before = _snapshot(port)
            want, got = _apply(ref, fn), _apply(port, fn)
            assert got == want, (seq, step, name)
            if isinstance(got, tuple) and got[0] == "error":
                # a refusal leaves the ledger as it was
                assert _snapshot(port) == before, (seq, step, name)
            assert _snapshot(port) == _snapshot(ref), (seq, step, name)
            inv = [_apply(m, lambda m: m.check_invariants())
                   for m in (ref, port)]
            assert inv[0] == inv[1] == None, (seq, step, name, inv)
            if isinstance(got, tuple) and got[0] == "error":
                n_errors += 1
            else:
                n_ok += 1
    assert n_errors > 100 and n_ok > 1000


def test_workers_sharing_a_device_are_distinct_entries():
    w = workers_of(["cpu"] * 2)
    assert w[0] != w[1] and w[0].device == w[1].device
    cpu = torch.device("cpu")
    assert w == [Worker(0, cpu), Worker(1, cpu)]
    pm = TP.PoolPartitionManager()
    pm.register(0, [w[0]])
    pm.register(1, [w[1]])
    with pytest.raises(TP.PartitionError, match="already held"):
        pm.register(2, [Worker(0, torch.device("cpu"))])
    loan = pm.lend(1, 0, [w[1]], whole=True)
    pm.park(1)
    pm.adopt(0, loan)
    assert pm.held_devices(0) == w and pm.holder_of(w[1]) == 0
    pm.check_invariants()
    assert pm.return_loan(loan) == [w[1]]
    pm.revive(1)
    pm.check_invariants()
    assert pm.held_devices(1) == [w[1]]
