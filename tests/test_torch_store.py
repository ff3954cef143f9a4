"""The port's control plane: stores, PrefixStore, LinearBarrier error
propagation and timeout, coordinator collectives across spawned ranks, the
c10d store adapter, and the lockstep tracer's divergence error. Modelled on
``tests/test_store.py`` and ``tests/test_collective_tracer.py``."""

import threading
import time

import pytest

from torchsnapshot_tpu_torch import collective_tracer as ct
from torchsnapshot_tpu_torch.parallel import coordinator as coordinator_mod
from torchsnapshot_tpu_torch.parallel.coordinator import Coordinator, get_coordinator
from torchsnapshot_tpu_torch.parallel.store import (
    BarrierError,
    BarrierTimeout,
    C10dStore,
    LinearBarrier,
    LocalStore,
    TCPStore,
)
from torchsnapshot_tpu_torch.test_utils import run_with_processes
from torchsnapshot_tpu_torch.utils import knobs


@pytest.fixture(autouse=True)
def _fresh_tracer():
    ct.reset_tracer()
    yield
    ct.reset_tracer()


def _c10d_store():
    import torch.distributed as dist

    return C10dStore(dist.HashStore())


@pytest.fixture(params=["local", "tcp", "c10d"])
def store(request):
    if request.param == "local":
        yield LocalStore()
    elif request.param == "c10d":
        yield _c10d_store()
    else:
        s = TCPStore("127.0.0.1", 0, is_server=True)
        yield s
        s.shutdown()


def test_set_get(store):
    store.set("k", b"v1")
    assert store.get("k", timeout_s=1) == b"v1"
    store.set("k", b"v2")
    assert store.get("k", timeout_s=1) == b"v2"
    assert store.try_get("nope") is None


def test_blocking_get(store):
    def delayed_set():
        time.sleep(0.2)
        store.set("later", b"x")

    threading.Thread(target=delayed_set).start()
    t0 = time.monotonic()
    assert store.get("later", timeout_s=5) == b"x"
    assert time.monotonic() - t0 >= 0.15


def test_get_timeout(store):
    with pytest.raises(TimeoutError):
        store.get("never", timeout_s=0.2)


def test_add_and_delete(store):
    assert store.add("ctr", 1) == 1
    assert store.add("ctr", 2) == 3
    assert store.add("other", 5) == 5
    store.set("gone", b"1")
    store.delete("gone")
    assert store.try_get("gone") is None
    assert store.try_get_many(["ctr", "nope"])[1] is None


def test_prefix(store):
    p1, p2 = store.prefix("a"), store.prefix("b")
    p1.set("k", b"1")
    p2.set("k", b"2")
    assert p1.get("k", timeout_s=1) == b"1"
    assert p2.get("k", timeout_s=1) == b"2"
    assert p1.prefix("c").try_get("k") is None


def test_tcp_store_multiple_clients():
    server = TCPStore("127.0.0.1", 0, is_server=True)
    client = TCPStore("127.0.0.1", server.port, is_server=False)
    client.set("x", b"from-client")
    assert server.get("x", timeout_s=1) == b"from-client"
    server.shutdown()


def _run_ranks(world, fn):
    results = {}

    def run(rank):
        try:
            results[rank] = fn(rank)
        except Exception as e:  # noqa: BLE001 - collected for assertions
            results[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return results


def test_linear_barrier_happy_path(store):
    order = []

    def run(rank):
        b = LinearBarrier(store, "b1", rank, 3)
        b.arrive(timeout_s=5)
        if rank == 0:
            order.append("critical")
        b.depart(timeout_s=5)
        order.append(f"done{rank}")

    _run_ranks(3, run)
    assert order[0] == "critical" and len(order) == 4


def test_linear_barrier_error_carries_rank_and_phase():
    store = LocalStore()

    def run(rank):
        b = LinearBarrier(store, "b3", rank, 2)
        if rank == 1:
            b.report_error(RuntimeError("disk on fire"), phase="write")
            return "reported"
        b.arrive(timeout_s=5)
        b.depart(timeout_s=5)

    results = _run_ranks(2, run)
    assert results[1] == "reported"
    e = results[0]
    assert isinstance(e, BarrierError) and e.rank == 1 and e.phase == "write"
    assert "rank 1" in str(e) and "disk on fire" in str(e)


def test_linear_barrier_timeout_names_missing_rank():
    store = LocalStore()
    b = LinearBarrier(store, "b4", 0, 3)
    LinearBarrier(store, "b4", 2, 3)._store.set("arrive/r2", b"1")
    with pytest.raises(BarrierTimeout) as info:
        b.arrive(timeout_s=0.3)
    assert info.value.missing_ranks == [1] and info.value.phase == "arrive"
    assert "waiting on rank(s) 1" in str(info.value)


def test_coordinator_collectives_in_threads():
    store = LocalStore()

    def run(rank):
        c = Coordinator(store, rank, 3)
        gathered = c.all_gather_object({"rank": rank})
        bcast = c.broadcast_object(f"from {rank}", src=2)
        g = c.gather_object(rank * 10, dst=1)
        sc = c.scatter_object([f"s{r}" for r in range(3)] if rank == 0 else None, src=0)
        c.barrier(timeout_s=5)
        return gathered, bcast, g, sc

    results = _run_ranks(3, run)
    for rank, (gathered, bcast, g, sc) in results.items():
        assert gathered == [{"rank": r} for r in range(3)]
        assert bcast == "from 2"
        assert g == ([0, 10, 20] if rank == 1 else None)
        assert sc == f"s{rank}"


def test_world_of_one_needs_no_store_traffic():
    c = get_coordinator()
    assert (c.get_rank(), c.get_world_size()) == (0, 1)
    assert c.all_gather_object(5) == [5] and c.broadcast_object(6) == 6
    c.barrier()


def _spawned_collectives(rank, world_size, use_pg):
    coord = get_coordinator()
    assert (coord.get_rank(), coord.get_world_size()) == (rank, world_size)
    assert isinstance(coord.store, C10dStore) == use_pg
    assert coord.all_gather_object(rank * rank) == [r * r for r in range(world_size)]
    assert coord.broadcast_object(rank + 7, src=1) == 8
    for i in range(3):
        coord.barrier(timeout_s=30)
    b = LinearBarrier(coord.store, "spawned", rank, world_size)
    if rank == world_size - 1:
        b.report_error(ValueError("spawned failure"), phase="commit")
    else:
        with pytest.raises(BarrierError, match="spawned failure") as info:
            b.arrive(timeout_s=30)
        assert info.value.rank == world_size - 1 and info.value.phase == "commit"
    # The lockstep tracer: rank 0 issues one collective more than the
    # others, and the next LinearBarrier names the divergence on every rank.
    with knobs.override_debug_collectives(True):
        ct.reset_tracer()
        coord.broadcast_object("same", src=0)
        if rank == 0:
            coord.broadcast_object("extra", src=0)
        barrier = LinearBarrier(coord.store, "lockstep-check", rank, world_size)
        with pytest.raises(ct.CollectiveDivergenceError) as err:
            barrier.arrive(timeout_s=30)
        assert err.value.seq == 2
        assert "_spawned_collectives" in str(err.value)


@pytest.mark.parametrize("use_pg", [False, True], ids=["tcpstore", "gloo-c10d"])
def test_coordinator_across_spawned_ranks(use_pg):
    run_with_processes(_spawned_collectives, 3, args=(use_pg,), process_group=use_pg)


def _fails_on_rank_one(rank, world_size):
    if rank == 1:
        raise RuntimeError("rank one fails")


def test_run_with_processes_names_the_failed_rank():
    with pytest.raises(RuntimeError, match=r"1/2 workers failed:\n--- rank 1 ---") as info:
        run_with_processes(_fails_on_rank_one, 2)
    assert "rank one fails" in str(info.value)


# ---------------------------------------------------------------------------
# The tracer's local contracts
# ---------------------------------------------------------------------------


def test_tracer_sequence_and_fingerprint():
    a, b = ct.CollectiveTracer(), ct.CollectiveTracer()
    assert (a.record("op.x", "k1"), a.record("op.y", "k2")) == (1, 2)
    b.record("op.y", "k2")
    b.record("op.x", "k1")
    assert a.digest()[0] == b.digest()[0] == 2 and a.digest()[1] != b.digest()[1]
    before = a.digest()
    a.record("barrier.report_error", "commit/1/p", checked=False)
    assert a.digest() == before and len(a.unchecked_entries()) == 1
    (_, _, _, site) = a.checked_entries()[0]
    assert "test_torch_store.py" in site


def test_tracer_divergence_names_both_sites():
    store = LocalStore()
    a, b = ct.CollectiveTracer(), ct.CollectiveTracer()
    a.record("coord.barrier", "coll/barrier/1")
    b.record("coord.broadcast_object", "coll/broadcast/1")
    out = {}

    def run(rank, tracer):
        try:
            tracer.crosscheck(store, rank, 2, "t", timeout_s=5)
        except ct.CollectiveDivergenceError as e:
            out[rank] = e

    th = threading.Thread(target=run, args=(1, b))
    th.start()
    run(0, a)
    th.join(10)
    assert out[0].seq == 1 and out[1].seq == 1
    assert "coord.barrier" in str(out[0]) and "coord.broadcast_object" in str(out[0])


def test_tracer_off_allocates_nothing():
    with knobs.override_debug_collectives(False):
        assert ct.active_tracer() is None
    assert ct._TRACER is None
    assert coordinator_mod._INSTALLED is None


@pytest.mark.parametrize("nbytes", [8 * 1024 * 1024 + 1, 20 * 1024 * 1024 + 5])
def test_c10d_store_moves_values_above_the_message_limit(nbytes):
    """c10d's libuv TCPStore refuses a message above 8 MiB; the broadcast
    and swarm restores post objects of up to 256 MiB through the
    coordinator's store, so C10dStore stores such values in parts."""
    import os as _os

    import torch.distributed as dist

    server = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", server.port, is_master=False)
    store = C10dStore(client)
    value = _os.urandom(nbytes)
    store.set("big", value)
    assert store.try_get("big") == value
    assert store.get("big") == value
    assert store.prefix("p").try_get_many(["x"]) == [None]
    store.delete("big")
    assert store.try_get("big") is None
    assert not client.check(["tss/big/#0"])  # the parts went too
    store.set("small", b"v")
    assert store.get("small") == b"v"


@pytest.mark.parametrize("parts", [0, 3])
def test_c10d_store_delete_of_parts_without_header_does_not_block(parts):
    """A writer that died part-way through a parted value, or a second
    deleter, leaves parts with no header: delete removes them at once
    instead of waiting on the header for the store's timeout."""
    import datetime

    import torch.distributed as dist

    raw = dist.HashStore()
    raw.set_timeout(datetime.timedelta(seconds=3))
    store = C10dStore(raw)
    for i in range(parts):
        raw.set(f"tss/orphan/#{i}", b"x" * 16)
    t0 = time.monotonic()
    store.delete("orphan")
    store.delete("orphan")  # a second deleter finds nothing
    assert time.monotonic() - t0 < 1.0
    assert not any(raw.check([f"tss/orphan/#{i}"]) for i in range(max(parts, 1)))
