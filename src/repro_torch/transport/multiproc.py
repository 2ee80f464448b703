"""Multi-process transport: one OS process per feature holder, TCP loopback.

The role-0 server (the parent) listens on 127.0.0.1; each spawned child
builds its worker from a picklable :class:`WorkerSpec` — so the child
holds ONLY its own tower params and feature source, constructed locally —
then connects and serves requests.  Messages are length-prefixed pickle
frames.  Tensors cross the wire as numpy arrays with their torch dtype
beside them (bfloat16 as its 16 bits, which numpy has no type for), and
the receiving side puts them on its own device: role 0 on the
transport's ``device``, a child on its worker's.  Python scalars (``step``,
``mb``, ``request``, ``pos``) stay Python scalars.

The ``spawn`` start method is used unconditionally: forking a process
that has initialised CUDA is unsafe, and spawn is what a real multi-host
launcher looks like anyway.  On a card every child opens its own CUDA
context and runs its tower there (the device is the spec's ``device``
kwarg; a child with no card fails its build and reports it in place of
its hello).  Role 0 builds the kernel library before spawning, so the K
children load it instead of each running ``nvcc``.

A child's seeded init must draw on the same device type as role 0's: the
CPU and CUDA generators give different numbers from one seed.  Role 0
verifies step 0 against its own copy of the towers (``train_split``'s
``_verify_step0``), so a mismatch fails loudly.  Tests inject state
instead: tensors in a spec's kwargs (a full param tree, a feature
table) cross as wire tensors, numpy arrays as they are (through
:func:`repro_torch.interop.tensor_from_numpy`), and both land on the
child's device before ``build`` runs.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.transport.base import Transport

_LEN = struct.Struct(">Q")


def send_msg(sock: socket.socket, payload: dict) -> None:
    data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        read = sock.recv_into(view[got:], n - got)
        if not read:
            raise ConnectionError("peer closed the connection")
        got += read
    return buf


def recv_msg(sock: socket.socket) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


@dataclass(frozen=True)
class _WireTensor:
    """A tensor on the wire: its values as a numpy array, its dtype by
    name (bfloat16 travels as int16 bits)."""

    array: np.ndarray
    dtype: str


def _to_wire(tree):
    """Tensors -> :class:`_WireTensor` (copied to the host, dtype kept);
    everything else passes through."""
    if isinstance(tree, dict):
        return {k: _to_wire(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_wire(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu")
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return _WireTensor(t.numpy(), name)
    return tree


def _from_wire(tree, device: torch.device):
    """The reverse, onto ``device``; numpy arrays (state a test injects
    into a spec) become tensors there too."""
    if isinstance(tree, dict):
        return {k: _from_wire(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_wire(v, device) for v in tree)
    if isinstance(tree, _WireTensor):
        a = tree.array if tree.array.flags.writeable else tree.array.copy()
        t = torch.from_numpy(a)
        if tree.dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)
    if isinstance(tree, np.ndarray):
        from repro_torch.interop import tensor_from_numpy

        return tensor_from_numpy(tree, device)
    return tree


@dataclass(frozen=True)
class WorkerSpec:
    """Picklable recipe: ``build(client_id, **kwargs) -> TowerWorker``.

    ``build`` must be a module-level callable importable in the child —
    the child constructs its own params and data from small config
    (seeds), as the launcher's specs carry; tensors or numpy arrays in
    ``kwargs`` (injected state) are copied to it.  ``kwargs["device"]``
    is where the child computes (``cuda`` when absent).  The spec crosses
    the spawn pipe with the process: past the pipe's buffer, starting a
    child waits until it has imported torch and read it, so a large spec
    serializes the K starts."""

    build: Callable
    kwargs: dict = field(default_factory=dict)


def _client_main(spec: WorkerSpec, client_id: int, port: int) -> None:
    try:
        device = resolve_device(spec.kwargs.get("device"))
        worker = spec.build(client_id, **_from_wire(spec.kwargs, device))
        device = worker.device or device
        failure = None
    except Exception as e:  # reported in place of the hello
        failure = e
    try:
        sock = socket.create_connection(("127.0.0.1", port))
    except OSError:
        return  # role 0 closed before this child connected
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        if failure is not None:
            send_msg(sock, {"op": "error", "client": client_id,
                            "error": f"build failed: {failure!r}"})
            return
        send_msg(sock, {"op": "hello", "client": client_id})
        while True:
            request = recv_msg(sock)
            try:
                resp = worker.handle(_from_wire(request, device))
                frame = None if resp is None else _to_wire(resp)
            except Exception as e:
                send_msg(sock, {"op": "error", "client": client_id,
                                "error": repr(e)})
                continue
            if frame is not None:
                send_msg(sock, frame)
                if frame["op"] == "bye":
                    return
    finally:
        sock.close()


class MultiprocTransport(Transport):
    """Role 0's end of K spawned feature holders.  Responses land on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for); a worker's
    exception, a failed build or a lost connection comes back from
    :meth:`next_response` as a ``RuntimeError`` naming the client."""

    def __init__(self, worker_specs: list[WorkerSpec], *,
                 device: DeviceLike = None,
                 connect_timeout_s: float = 120.0):
        self.device = resolve_device(device)
        self.num_clients = len(worker_specs)
        self._closed = False
        self._procs: list = []
        self._conns: list[Optional[socket.socket]] = [None] * self.num_clients
        self._responses: queue.SimpleQueue = queue.SimpleQueue()
        self._send_locks = [threading.Lock() for _ in range(self.num_clients)]
        self._readers: list[threading.Thread] = []
        if self.device.type == "cuda":
            # one nvcc build here; the children load the library it leaves
            from repro_torch.kernels import build

            build.library()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self.num_clients)
        port = self._listener.getsockname()[1]

        ctx = mp.get_context("spawn")
        self._procs = [
            ctx.Process(target=_client_main,
                        args=(WorkerSpec(spec.build, _to_wire(spec.kwargs)),
                              k, port),
                        daemon=True, name=f"splitnn-client{k}")
            for k, spec in enumerate(worker_specs)
        ]
        for p in self._procs:
            p.start()
        try:
            self._accept_all(connect_timeout_s)
        except BaseException:
            self.close()
            raise
        self._readers = [
            threading.Thread(target=self._read_loop, args=(k,), daemon=True,
                             name=f"splitnn-reader{k}")
            for k in range(self.num_clients)
        ]
        for t in self._readers:
            t.start()

    def _accept_all(self, timeout_s: float) -> None:
        """Take the K hellos (children import torch and build their
        towers first, so be patient); a child that reports a failed build
        or exits before connecting raises at once."""
        deadline = time.monotonic() + timeout_s
        self._listener.settimeout(0.5)
        while any(c is None for c in self._conns):
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                for k, p in enumerate(self._procs):
                    if self._conns[k] is None and p.exitcode is not None:
                        raise RuntimeError(
                            f"client {k} exited with code {p.exitcode} "
                            "before connecting")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"not all {self.num_clients} clients connected "
                        f"within {timeout_s}s")
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = recv_msg(conn)
            self._conns[hello["client"]] = conn
            if hello["op"] == "error":
                raise RuntimeError(f"client {hello['client']} worker failed: "
                                   f"{hello['error']}")

    def _read_loop(self, client: int) -> None:
        conn = self._conns[client]
        while True:
            try:
                resp = recv_msg(conn)
                if resp["op"] == "bye":
                    return
                if resp["op"] != "error":
                    resp = _from_wire(resp, self.device)
            except Exception as e:
                if not self._closed:  # a lost child, not a shutdown
                    self._responses.put((client, {
                        "op": "error", "client": client,
                        "error": f"connection lost: {e!r}"}))
                return
            self._responses.put((client, resp))

    def submit(self, client: int, request: dict) -> None:
        frame = _to_wire(request)
        with self._send_locks[client]:
            send_msg(self._conns[client], frame)

    def next_response(self, timeout: Optional[float] = None):
        try:
            client, resp = self._responses.get(timeout=timeout)
        except queue.Empty:
            return None
        if resp.get("op") == "error":
            raise RuntimeError(
                f"client {client} worker failed: {resp['error']}")
        return client, resp

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # a child still building gets a refused connection and exits
        self._listener.close()
        for k, conn in enumerate(self._conns):
            if conn is None:
                continue
            try:
                with self._send_locks[k]:
                    send_msg(conn, {"op": "shutdown"})
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=10.0)
        # a child that missed the shutdown (a hung forward, a wedged
        # socket) must not outlive the transport: escalate terminate ->
        # kill, joining after each signal (an unjoined child is a zombie)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for conn in self._conns:
            if conn is not None:
                conn.close()
        for t in self._readers:
            t.join(timeout=5.0)
