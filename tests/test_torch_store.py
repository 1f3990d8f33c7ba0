"""The port's TCPStore (`paddle_tpu_torch/distributed/store.py`): the JAX
package's store tests mirrored on the port (set / get / add / barrier,
reconnect under injected socket drops with exactly-once retries, typed
deadlines, CAS, fencing epochs, the frame cap, codec fuzz, the WAL and
snapshot with torn-tail and bad-CRC records, lease grace, crash and
restart), then the cross-package contract: the codec's bytes are the
JAX module's, a client of either package works against a master of the
other, and each package's `recover` rebuilds the other's WAL and
snapshot to the same key map.

Every master binds an ephemeral port (0).  No assertion depends on host
scheduling: deadlines that must expire can never be met, and waits
poll under deadlines far above what they wait for."""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.distributed import StoreError, StoreTimeout, TCPStore
from paddle_tpu_torch.distributed.store import (_MAX_FRAME, _Durable,
                                                _grace_leases, _pack_bytes,
                                                _unpack)
from paddle_tpu_torch.inference.fleet_serving import ReplicaLease
from paddle_tpu_torch.observability import get_registry
import paddle_tpu_torch.distributed.store as S
from paddle_tpu_torch.testing import (InjectedConnectionError, corrupt_bytes,
                                      faults, get_injector, truncate_file)

# every codec type, nested: None, bools, ints (big and negative), floats,
# str (non-ASCII), bytes, list / tuple / dict compounds
RICH = {"n": None, "t": True, "f": False, "i": -(2 ** 70), "x": 2.5,
        "s": "héllo", "b": b"\x00\xff", "l": [1, [2, (3, "4")]],
        "tu": (1.0, 2.0, 3), 7: {"k": [b"", ""]}}


@pytest.fixture
def inj():
    """The port's injector switched on, cleared before and after."""
    i = get_injector()
    i.clear()
    faults.ENABLED = True
    yield i
    i.clear()
    faults.ENABLED = False


def _master(**kw):
    return TCPStore("127.0.0.1", 0, is_master=True, **kw)


def _jax_store():
    pytest.importorskip("jax")
    from paddle_tpu.distributed import store as J
    return J


# -- the JAX suite's store tests, on the port --------------------------------


def test_tcp_store_set_get_add_barrier():
    master = _master()
    client = TCPStore("127.0.0.1", master.port)
    client.set("key", [1, 2, 3])
    assert master.get("key") == [1, 2, 3]
    assert client.add("n", 2) == 2
    assert master.add("n", 3) == 5
    master.barrier("b1", 1)
    assert client.delete_key("key") is True
    assert client.get("key") is None
    assert client.list_keys() == {"n": 5, "__barrier/b1": 1}
    client.set("rich", RICH)
    assert master.get("rich") == RICH
    client.close()
    master.close()


def test_store_rpc_drop_mid_barrier_reconnects(inj):
    """Two injected socket drops inside barrier(): the client reconnects
    with backoff and the barrier completes, and the master's dedup makes
    the retried `add` count once."""
    master = _master()
    client = TCPStore("127.0.0.1", master.port)
    reconnects0 = get_registry().get("store_reconnects_total").value
    rule = inj.inject("store.rpc", exc=InjectedConnectionError, after=0,
                      times=2)
    client.barrier("mid_drop", 1, timeout=30)
    assert rule.fired == 2
    assert get_registry().get("store_reconnects_total").value \
        >= reconnects0 + 1
    assert master.get("__barrier/mid_drop") == 1
    client.close()
    master.close()


def test_retried_add_after_lost_reply_applies_once():
    """An ambiguous failure: the master applied the add, the reply never
    arrived.  The client's retry carries the same op id and gets the
    recorded reply; the counter moved once."""
    master = _master()
    client = TCPStore("127.0.0.1", master.port)
    assert client.add("gen", 1) == 1
    sent = {}
    real_recv = S._recv_msg
    me = threading.current_thread()

    def lose_first_reply(sock):
        # the client's first reply only (the master's handler threads
        # read requests through the same function)
        if threading.current_thread() is me and not sent:
            sent["lost"] = real_recv(sock)     # applied, then dropped
            raise ConnectionError("reply lost")
        return real_recv(sock)

    S._recv_msg = lose_first_reply
    try:
        assert client.add("gen", 1) == 2
    finally:
        S._recv_msg = real_recv
    assert sent["lost"] == ("ok", 2)
    assert master.get("gen") == 2
    client.close()
    master.close()


def test_store_op_deadline_is_typed(inj):
    master = _master()
    client = TCPStore("127.0.0.1", master.port)
    inj.inject("store.rpc", exc=InjectedConnectionError, times=None)
    t0 = time.monotonic()
    with pytest.raises(StoreTimeout):
        client.get("k", timeout=0.6)
    assert time.monotonic() - t0 < 60      # bounded, not hung
    assert issubclass(StoreTimeout, (StoreError, TimeoutError))
    inj.clear()
    assert client.ping() == "pong"         # recovers once faults stop
    client.close()
    master.close()


def test_store_wait_and_barrier_deadlines():
    master = _master()
    with pytest.raises(StoreTimeout):
        master.wait(["never"], timeout=0.3)
    with pytest.raises(StoreTimeout):
        master.barrier("lonely", 2, timeout=0.3)
    master.close()


def test_store_compare_and_set():
    master = _master()
    ok, cur = master.compare_and_set("lease", None, "owner-a")
    assert ok and cur == "owner-a"
    ok, cur = master.compare_and_set("lease", "owner-b", "owner-c")
    assert not ok and cur == "owner-a"
    ok, cur = master.compare_and_set("lease", "owner-a", "owner-b")
    assert ok and cur == "owner-b"
    master.close()


def test_fencing_epoch_scopes_barriers():
    master = _master()
    assert master.fence_epoch("job") == 0
    master.barrier("sync", 1, epoch=0)
    assert master.bump_fence_epoch("job") == 1
    with pytest.raises(StoreTimeout):
        # the next generation needs 2; the epoch-0 increment is elsewhere
        master.barrier("sync", 2, timeout=0.4, epoch=1)
    assert master.fence_epoch("job") == 1
    master.close()


def test_recv_frame_cap_and_oversized_send():
    master = _master()
    client = TCPStore("127.0.0.1", master.port)
    with pytest.raises(ValueError, match="cap"):
        client.set("big", b"x" * (_MAX_FRAME + 1))
    s = socket.create_connection(("127.0.0.1", master.port), timeout=5)
    s.sendall(struct.pack("!I", 0xFFFFFFF0) + b"junk")
    s.close()
    assert client.ping() == "pong"
    client.close()
    master.close()


def test_codec_fuzz_server_stays_serviceable():
    master = _master()
    rng = np.random.RandomState(1234)
    for i in range(60):
        s = socket.create_connection(("127.0.0.1", master.port), timeout=5)
        kind = i % 4
        payload = rng.bytes(int(rng.randint(1, 200)))
        try:
            if kind == 0:
                s.sendall(struct.pack("!I", len(payload)) + payload)
            elif kind == 1:
                s.sendall(struct.pack("!I", len(payload) + 64) + payload)
            elif kind == 2:
                s.sendall(struct.pack("!I", int(rng.randint(
                    _MAX_FRAME + 1, 2 ** 31))) + payload)
            else:
                s.sendall(payload[:3])
        finally:
            s.close()
    client = TCPStore("127.0.0.1", master.port, timeout=10)
    client.set("after_fuzz", [1, 2, 3])
    assert client.get("after_fuzz") == [1, 2, 3]
    assert client.add("ctr", 2) == 2
    client.close()
    master.close()


def test_store_close_releases_listen_fd():
    master = _master()
    port = master.port
    master.close()
    again = TCPStore("127.0.0.1", port, is_master=True)
    assert again.ping() == "pong"
    again.close()


# -- durability: WAL, snapshot, lease grace, crash / restart ------------------


def test_wal_replay_and_snapshot_seq_gating(tmp_path):
    root = str(tmp_path / "d")
    d = _Durable(root, snapshot_every=1000)
    d.append(1, "set", "a", 1, None, None)
    d.append(2, "add", "n", 5, "op-1", 5)
    d.append(3, "add", "n", 5, "op-2", 10)
    d.append(4, "delete", "a", None, None, None)
    d.append(5, "cas", "c", [None, "won"], None, None)
    kv, applied, seq, last_t, stats = _Durable.recover(root)
    assert kv == {"n": 10, "c": "won"}
    assert seq == 5 and stats["wal_records"] == 5
    assert not stats["snapshot"] and not stats["wal_torn"]
    assert applied["op-1"] == 5 and applied["op-2"] == 10
    assert last_t is not None
    d.snapshot(kv, applied, seq)
    d.append(6, "add", "n", 1, None, None)
    d.close()
    kv2, _, seq2, _, stats2 = _Durable.recover(root)
    assert kv2 == {"n": 11, "c": "won"}
    assert seq2 == 6
    assert stats2["snapshot"] and stats2["wal_records"] == 1


def test_wal_torn_tail_ends_replay(tmp_path):
    root = str(tmp_path / "d")
    d = _Durable(root)
    for i in range(3):
        d.append(i + 1, "set", f"k{i}", i, None, None)
    d.close()
    wal = os.path.join(root, _Durable.WAL)
    assert truncate_file(wal, os.path.getsize(wal) - 3) > 0
    kv, _, seq, _, stats = _Durable.recover(root)
    assert stats["wal_torn"] and stats["wal_records"] == 2
    assert kv == {"k0": 0, "k1": 1} and seq == 2


def test_wal_crc_bad_record_is_skipped_not_fatal(tmp_path):
    root = str(tmp_path / "d")
    d = _Durable(root)
    d.append(1, "set", "k0", 0, None, None)
    frame0_end = os.path.getsize(os.path.join(root, _Durable.WAL))
    d.append(2, "set", "k1", 1, None, None)
    d.append(3, "set", "k2", 2, None, None)
    d.close()
    wal = os.path.join(root, _Durable.WAL)
    assert corrupt_bytes(wal, offset=frame0_end + 8 + 2) == \
        [frame0_end + 8 + 2]
    kv, _, seq, _, stats = _Durable.recover(root)
    assert stats["wal_skipped"] == 1 and not stats["wal_torn"]
    assert kv == {"k0": 0, "k2": 2} and seq == 3


def test_bad_snapshot_is_ignored_wal_still_replays(tmp_path):
    root = str(tmp_path / "d")
    d = _Durable(root)
    d.append(1, "set", "a", 1, None, None)
    d.snapshot({"a": 1}, {}, 1)
    d.append(2, "set", "b", 2, None, None)
    d.close()
    corrupt_bytes(os.path.join(root, _Durable.SNAP), n=3, seed=4)
    kv, _, seq, _, stats = _Durable.recover(root)
    assert not stats["snapshot"] and kv == {"b": 2} and seq == 2


def test_lease_grace_math():
    kv = {"fleet/j/replica/r0": (100.0, 5.0, 3),
          "fleet/j/replica/r1": [200.0, 2.0, 1],
          "fleet/j/replica/r0/gen": 3,
          "other": (1.0, 2.0, 3.0)}
    assert _grace_leases(dict(kv), 0.0) == 0
    graced = dict(kv)
    assert _grace_leases(graced, 2.5) == 2
    assert graced["fleet/j/replica/r0"] == (102.5, 5.0, 3)
    assert graced["fleet/j/replica/r1"] == [202.5, 2.0, 1]
    assert graced["fleet/j/replica/r0/gen"] == 3
    assert graced["other"] == (1.0, 2.0, 3.0)


def test_store_crash_restart_recovers_and_graces_leases(tmp_path):
    store = _master(durable_dir=str(tmp_path / "store"))
    client = TCPStore("127.0.0.1", store.port, timeout=30)
    try:
        # an interval far above the test: no heartbeat moves the lease
        lease = ReplicaLease(store, "j", "r0", ttl=30.0, interval=600.0)
        lease.register()
        store.set("plain", {"x": 1})
        client.add("ctr", 7)
        before = store.get("fleet/j/replica/r0")
        store.crash()
        assert store.crashed.is_set()
        time.sleep(0.3)
        rec = store.restart()
        assert not store.crashed.is_set()
        assert rec["keys"] >= 4 and rec["graced_leases"] == 1
        assert rec["outage_s"] >= 0.3 and rec["wal_records"] >= 4
        # the client rides its reconnect path to the same port
        assert client.get("plain") == {"x": 1}
        assert int(client.get("ctr")) == 7
        after = store.get("fleet/j/replica/r0")
        assert float(after[0]) >= float(before[0]) + rec["outage_s"] - 1e-3
        assert tuple(after[1:]) == tuple(before[1:])
        with pytest.raises(StoreError, match="crash"):
            store.restart()
        lease.release()
    finally:
        client.close()
        store.close()


def _port_closed(port):
    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    except OSError:
        return True
    return False


def test_store_crash_fault_site_then_restart(tmp_path, inj):
    """`store.crash` tears the master down inside a request, before the
    op applies.  The client's retry either reached the master before
    the teardown finished (applied once, logged before its reply) or
    timed out; after the restart the counter shows exactly that."""
    store = _master(durable_dir=str(tmp_path / "s"))
    client = TCPStore("127.0.0.1", store.port, timeout=60)
    try:
        client.set("k", 1)
        inj.inject("store.crash", times=1)
        try:
            got = client.add("n", 1, timeout=2.0)
        except StoreTimeout:
            got = None
        deadline = time.monotonic() + 60
        while not (store.crashed.is_set() and _port_closed(store.port)) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert store.crashed.is_set() and _port_closed(store.port)
        inj.clear()
        rec = store.restart()
        assert rec["keys"] in (1, 2) and client.get("k") == 1
        n = client.get("n")
        assert n in (None, 1) and (got is None or n == got)
        assert client.add("n", 1) == (n or 0) + 1
    finally:
        client.close()
        store.close()


def test_wal_fsync_and_snapshot_every(tmp_path):
    root = str(tmp_path / "w")
    store = _master(durable_dir=root, wal_fsync=True, snapshot_every=4)
    try:
        for i in range(10):
            store.add("n", 1)
        store.set("z", [1])
    finally:
        store.close()
    kv, _, seq, _, stats = _Durable.recover(root)
    assert kv == {"n": 10, "z": [1]} and seq == 11
    assert stats["snapshot"] and stats["wal_records"] == 3


# -- across the packages -----------------------------------------------------


def test_codec_bytes_equal_jax():
    J = _jax_store()
    assert _pack_bytes(RICH) == J._pack_bytes(RICH)
    raw = J._pack_bytes(RICH)
    assert _unpack(raw, 0) == (RICH, len(raw))
    assert J._MAX_FRAME == _MAX_FRAME


@pytest.mark.parametrize("master_pkg", ["jax", "port"])
def test_client_of_one_package_on_a_master_of_the_other(master_pkg):
    J = _jax_store()
    Master, Client = (J.TCPStore, TCPStore) if master_pkg == "jax" \
        else (TCPStore, J.TCPStore)
    master = Master("127.0.0.1", 0, is_master=True)
    client = Client("127.0.0.1", master.port, timeout=30)
    try:
        client.set("rich", RICH)
        assert master.get("rich") == RICH
        assert client.add("n", 2) == 2 and master.add("n", 3) == 5
        assert client.compare_and_set("c", None, "a") == (True, "a")
        assert client.compare_and_set("c", "x", "b") == (False, "a")
        assert client.bump_fence_epoch("job") == 1
        client.barrier("b", 1, epoch=1)
        assert client.delete_key("rich") is True
        assert master.list_keys() == client.list_keys() == {
            "n": 5, "c": "a", "elastic/job/epoch": 1, "__barrier/e1/b": 1}
        assert client.ping() == "pong"
    finally:
        client.close()
        master.close()


def _write_history(Store, root):
    """One master's history over `root`: mutations of every kind, a
    snapshot past `snapshot_every`, more records after it, a lease."""
    s = Store("127.0.0.1", 0, is_master=True, durable_dir=root,
              snapshot_every=5)
    try:
        for i in range(7):
            s.add("ctr", i)
        s.set("rich", RICH)
        s.compare_and_set("cas", None, ["won", 1])
        s.set("gone", 1)
        s.delete_key("gone")
        s.set("fleet/j/replica/r0", (time.time(), 5.0, 2))
    finally:
        s.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recover_rebuilds_the_other_packages_wal(tmp_path, writer):
    """The WAL and snapshot one package's master wrote recover to the
    same key map, seq and dedup cache in both packages, and a master of
    the reading package restarts over them and serves the keys."""
    J = _jax_store()
    root = str(tmp_path / "d")
    _write_history(J.TCPStore if writer == "jax" else TCPStore, root)
    mine = _Durable.recover(root)
    theirs = J._Durable.recover(root)
    assert mine[:3] == theirs[:3] and mine[4] == theirs[4]
    kv = mine[0]
    assert kv["ctr"] == 21 and kv["rich"] == RICH
    assert kv["cas"] == ["won", 1] and "gone" not in kv
    assert mine[4]["snapshot"] and mine[4]["wal_records"] > 0
    Reader = TCPStore if writer == "jax" else J.TCPStore
    r = Reader("127.0.0.1", 0, is_master=True, durable_dir=root)
    try:
        assert r.recovered["keys"] == len(kv)
        assert r.recovered["graced_leases"] == 1
        assert r.get("rich") == RICH and r.add("ctr", 1) == 22
    finally:
        r.close()
