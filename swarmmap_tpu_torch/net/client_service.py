"""Client-side network service (copy of swarmmap_tpu/net/client_service.py).

Reference spec: ClientService (code/src/ClientService.cc)
— Register (dispatch handshake returning "id port"), Connect (persistent
data channel), ReportState / PushMap senders, and the OnRequest handler
(DistributeMap -> Map::UpdateMap, PushMap -> Mapit::ReceivePush).
"""
from __future__ import annotations

import threading

from ..sync import codec
from ..sync.codec import Request
from ..utils.logging import get_logger
from .wsrpc import WsClient, ws_round_trip

_log = get_logger("clientservice")


class ClientService:
    def __init__(self, agent, host: str):
        """`agent` is a swarm.SwarmAgent (system + mapit)."""
        self.agent = agent
        self.host = host
        self.client: WsClient | None = None
        self.server_id = -1
        self._pull_done = threading.Event()

    # ------------------------------------------------------------------
    def register(self, dispatch_port: int) -> tuple[int, int]:
        """Handshake: returns (assigned id, data port) and re-keys the
        local map id (reference: Map::SetId)."""
        reply = ws_round_trip(
            self.host, dispatch_port,
            Request(src=-1, dst=0, path="Register", body=b""),
        )
        new_id, data_port = codec.decode_register_reply(reply.body)
        self.agent.system.store.set_map_id(new_id)
        self.agent.agent_id = new_id
        _log.info("registered: id=%d data_port=%d", new_id, data_port)
        return new_id, data_port

    def connect(self, data_port: int):
        self.client = WsClient(self.host, data_port, on_request=self._on_request)
        self.client.connect()

    # ------------------------------------------------------------------
    def report_state(self):
        self.client.send(Request(
            src=self.agent.agent_id, dst=0, path="ReportState",
            body=self.agent.state_payload(),
        ))

    def push_map(self) -> int:
        payload = self.agent.push_payload()
        if payload is None:
            return 0
        self.client.send(Request(
            src=self.agent.agent_id, dst=0, path="PushMap", body=payload,
        ))
        return len(payload)

    def pull_map(self, timeout: float | None = None) -> bool:
        """Ask the server for its latest keyframes (Mapit::Pull — an
        empty stub in the reference, src/Mapit.cc:164; here the verb is
        live).  The ReplyPull slice applies like a distribute.  With a
        timeout, blocks until the reply landed."""
        self._pull_done.clear()
        self.client.send(Request(
            src=self.agent.agent_id, dst=0, path="PullMap", body=b"",
        ))
        if timeout is None:
            return True
        return self._pull_done.wait(timeout)

    # ------------------------------------------------------------------
    def _on_request(self, req: Request):
        if req.path == "DistributeMap":
            self.agent.receive_distribute(req.body)
        elif req.path == "PushMap":
            self.agent.receive_distribute(req.body)
        elif req.path == "ReplyPull":
            self.agent.receive_distribute(req.body)
            self._pull_done.set()
        else:
            _log.warning("unhandled request path %s", req.path)

    def close(self):
        if self.client is not None:
            self.client.close()
