"""Server-side network services (copy of swarmmap_tpu/net/server_service.py).

Reference spec: ServerService (code/src/ServerService.cc)
— per-mediator data service bound at port 2328+id (:29), DistributeMap
broadcast, and OnRequest routing (ReportState -> AgentMediator::SetState,
PushMap -> MediatorScheduler::EnqueueRequest); the dispatch service hands
out (id, port) pairs (reference: server.cc:86-126 DispatchId).
"""
from __future__ import annotations

import threading

from ..sync import codec
from ..sync.codec import Request
from ..utils.logging import get_logger
from .wsrpc import WsServer

_log = get_logger("serverservice")

BASE_DATA_PORT = 2328  # reference: ServerService.cc:29


class ServerService:
    """One data channel per mediator."""

    def __init__(self, mediator_id: int, scheduler, host: str = "0.0.0.0",
                 port: int | None = None):
        self.mediator_id = mediator_id
        self.scheduler = scheduler
        self.port = port if port is not None else BASE_DATA_PORT + mediator_id
        self.server = WsServer(host, self.port, self._on_request)

    def start(self):
        self.server.start()

    def distribute_map(self, payload: bytes):
        self.server.broadcast(Request(
            src=0, dst=self.mediator_id, path="DistributeMap", body=payload,
        ))

    def _on_request(self, req: Request, reply):
        if req.path == "ReportState":
            self.scheduler.report_state(self.mediator_id, codec.decode_state(req.body))
        elif req.path == "PushMap":
            self.scheduler.enqueue_request(self.mediator_id, req.body)
        elif req.path == "PullMap":
            # client asks for the optimized map tail (Mapit::Pull /
            # ReplyPull, src/Mapit.cc:164-196)
            payload = self.scheduler.reply_pull(self.mediator_id)
            if payload is not None:
                reply(Request(src=0, dst=self.mediator_id,
                              path="ReplyPull", body=payload))
        else:
            _log.warning("unhandled path %s", req.path)

    def stop(self):
        self.server.stop()


class DispatchService:
    """The registration endpoint: assigns agent ids and spins up a
    mediator + data service per client."""

    def __init__(self, host: str, port: int, make_mediator, next_id: int = 0):
        """make_mediator(agent_id) -> ServerService (started)."""
        self.host = host
        self.port = port
        self.make_mediator = make_mediator
        self._next_id = next_id
        self._lock = threading.Lock()
        self.server = WsServer(host, port, self._on_request)

    def start(self):
        self.server.start()

    def _on_request(self, req: Request, reply):
        if req.path != "Register":
            _log.warning("dispatch got unexpected path %s", req.path)
            return
        with self._lock:
            agent_id = self._next_id
            self._next_id += 1
        svc = self.make_mediator(agent_id)
        reply(Request(src=0, dst=agent_id, path="Register",
                      body=codec.encode_register_reply(agent_id, svc.port)))
        _log.info("dispatched id=%d port=%d", agent_id, svc.port)

    def stop(self):
        self.server.stop()
