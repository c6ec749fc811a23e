"""The port's frame RPC transport and socket control plane against the
reference's (``tests/test_rpc_socket.py``'s scenarios).

The wire units run on both packages and across them: a frame one
package sends is the frame the other reads, byte for byte.  The end to
end test stands the port's ``JobSocketServer`` up in a child process and
drives submit/pause/resume/status/drain through a ``JobServiceClient``
of either package from the parent; the job's final status record, times
taken out, must equal the reference's own service running the same job.
"""

import multiprocessing as mp
import socket
import struct
import threading
import time

import pytest

from repro.core import rpc as jrpc

from repro_torch.core import rpc
from repro_torch.core.rpc import (MAX_FRAME_BYTES, FrameClient, FrameServer,
                                  RPCError, recv_frame, send_frame)

RPCS = {"jax": jrpc, "port": rpc}

#: record fields measured on the host clock; every other field must match
_TIMES = {"pool_seconds", "submitted", "cold_start_seconds"}


# ---------------------------------------------------------------------------
# Wire-format units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sender,receiver", [("port", "port"),
                                             ("port", "jax"),
                                             ("jax", "port")])
def test_frames_cross_packages_byte_for_byte(sender, receiver):
    a, b = socket.socketpair()
    try:
        msg = {"method": "status", "job_id": "j1", "n": [1, 2, 3],
               "s": "ünï"}
        RPCS[sender].send_frame(a, msg)
        assert RPCS[receiver].recv_frame(b) == msg
        for i in range(3):
            RPCS[sender].send_frame(a, {"i": i})
        assert [RPCS[receiver].recv_frame(b)["i"] for _ in range(3)] == \
            [0, 1, 2]
    finally:
        a.close()
        b.close()
    wire = {}
    for name, mod in RPCS.items():
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, msg)
            a.close()
            wire[name] = b.recv(1 << 16)
        finally:
            b.close()
    assert wire["port"] == wire["jax"]
    assert struct.unpack(">I", wire["port"][:4])[0] == len(wire["port"]) - 4
    assert rpc.MAX_FRAME_BYTES == jrpc.MAX_FRAME_BYTES


def test_recv_frame_returns_none_on_clean_eof_and_raises_mid_frame():
    a, b = socket.socketpair()
    a.close()
    assert recv_frame(b) is None          # EOF between frames: orderly
    b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00")            # half a length header
        a.close()
        with pytest.raises(ConnectionError, match="mid-frame"):
            recv_frame(b)
    finally:
        b.close()


def test_oversize_frames_rejected_both_directions():
    a, b = socket.socketpair()
    try:
        with pytest.raises(ValueError, match="exceeds"):
            send_frame(a, "x" * MAX_FRAME_BYTES)   # + quotes > cap
        a.sendall(struct.pack(">I", MAX_FRAME_BYTES + 1))
        with pytest.raises(RPCError, match="MAX_FRAME_BYTES"):
            recv_frame(b)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# FrameServer / FrameClient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_frame_server_echo_roundtrip(client_pkg):
    with FrameServer(lambda req: {"ok": True, "echo": req}) as srv:
        with RPCS[client_pkg].FrameClient(srv.address) as client:
            assert client.call({"x": 1}) == {"ok": True, "echo": {"x": 1}}
            for i in range(5):
                assert client.call({"i": i})["echo"]["i"] == i


def test_handler_errors_become_error_replies_not_disconnects():
    def handle(req):
        if req.get("boom"):
            raise ValueError("kaput")
        return {"ok": True, "obj": object()}    # not JSON-serializable

    with FrameServer(handle) as srv, FrameClient(srv.address) as client:
        resp = client.call({"boom": True})
        assert resp["ok"] is False and "ValueError: kaput" in resp["error"]
        resp = client.call({})
        assert resp["ok"] is False and "TypeError" in resp["error"]
        assert client.call({"boom": True})["ok"] is False


def test_concurrent_clients_serialize_through_the_dispatch_lock():
    state = {"n": 0}

    def handle(req):
        seen = state["n"]
        time.sleep(0.002)                 # widen any race window
        state["n"] = seen + 1
        return {"ok": True, "n": state["n"]}

    with FrameServer(handle) as srv:
        def worker():
            with FrameClient(srv.address) as c:
                for _ in range(10):
                    c.call({})

        threads = [threading.Thread(target=worker) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert state["n"] == 30               # lost updates mean a broken lock


def test_client_exhausts_retries_then_raises_rpcerror():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()                         # nobody listening here now
    client = FrameClient(("127.0.0.1", port), timeout=0.2, retries=1,
                         retry_delay=0.01)
    with pytest.raises(RPCError, match="after 2 attempt"):
        client.call({"method": "status"})


# ---------------------------------------------------------------------------
# End to end: control plane across a real process boundary
# ---------------------------------------------------------------------------

_EVENTS = [(float(i) * 0.5, f"k{i % 4}", float(i % 7)) for i in range(200)]


def _program(Pipeline, Windowing, **build):
    return (Pipeline.from_source(batch_records=50).key_by()
            .window(Windowing.tumbling(25.0)).reduce("sum")
            .sink("stream-output/")
            .build(num_buckets=16, n_workers=4, batch_records=50,
                   job_id="rollup-1", **build))


def _serve_job_service(conn):
    """Child process: the port's JobServer behind its JobSocketServer on
    the CPU; report the bound address, serve until the parent is done."""
    from repro_torch.core import MemoryStore, MetadataStore
    from repro_torch.launch.serve import JobRPC, JobSocketServer
    from repro_torch.pipeline import Pipeline, Windowing
    from repro_torch.service import JobServer
    from repro_torch.streaming import write_event_log

    store = MemoryStore()
    write_event_log(store, "gps/", _EVENTS, segment_records=64)
    server = JobServer(store, MetadataStore())
    server.add_tenant("alice")
    rpc_ = JobRPC(server)
    rpc_.register("rollup", _program(Pipeline, Windowing, device="cpu"))
    with JobSocketServer(rpc_) as srv:
        conn.send(list(srv.address))
        conn.recv()                       # block until the parent is done
    conn.close()


def _reference_status():
    """The reference's service running the same job in-process, through
    the same verbs."""
    from repro.core import MemoryStore, MetadataStore
    from repro.launch.serve import JobRPC
    from repro.pipeline import Pipeline, Windowing
    from repro.service import JobServer
    from repro.streaming import write_event_log

    store = MemoryStore()
    write_event_log(store, "gps/", _EVENTS, segment_records=64)
    server = JobServer(store, MetadataStore())
    server.add_tenant("alice")
    rpc_ = JobRPC(server)
    rpc_.register("rollup", _program(Pipeline, Windowing))
    for req in ({"method": "submit", "tenant": "alice", "program": "rollup",
                 "source_prefix": "gps/"},
                {"method": "pause", "job_id": "rollup-1"},
                {"method": "resume", "job_id": "rollup-1"},
                {"method": "drain"}):
        assert rpc_.handle(req)["ok"]
    return rpc_.handle({"method": "status", "job_id": "rollup-1"})["result"]


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_control_plane_verbs_round_trip_between_processes(client_pkg):
    if client_pkg == "port":
        from repro_torch.core import JobServiceClient
    else:
        from repro.core import JobServiceClient
    ctx = mp.get_context("spawn")         # fresh interpreter: no inherited
    parent_conn, child_conn = ctx.Pipe()  # thread state from pytest
    proc = ctx.Process(target=_serve_job_service, args=(child_conn,),
                       daemon=True)
    proc.start()
    try:
        assert parent_conn.poll(120), "server child never came up"
        address = tuple(parent_conn.recv())
        client = JobServiceClient(address=address, timeout=30.0)
        try:
            jid = client.submit("alice", "rollup", source_prefix="gps/")
            assert client.status(jid)["state"] == "PENDING"
            client.pause(jid)
            assert client.status(jid)["state"] == "PAUSED"
            client.resume(jid)
            assert client.status(jid)["state"] != "PAUSED"
            states = client.drain(timeout=120.0)
            assert states[jid] == "DONE"
            st = client.status(jid)
            assert st["state"] == "DONE" and st["windows_emitted"] > 0
            assert st["checkpointed_offset"] == 200 and st["lag"] == 0
            assert st["fold_invocations"] > 0 and st["pool_seconds"] > 0
            assert jid in client.jobs()
            ref = _reference_status()
            assert {k: v for k, v in st.items() if k not in _TIMES} == \
                {k: v for k, v in ref.items() if k not in _TIMES}
            with pytest.raises(Exception, match="KeyError"):
                client.status("no-such-job")
            with pytest.raises(Exception, match="no program registered"):
                client.submit("alice", "ghost", source_prefix="gps/")
        finally:
            client.close()
        parent_conn.send("done")
        proc.join(timeout=30)
        assert proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
