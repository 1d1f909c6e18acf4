"""Standalone edge server (reference: code/Examples/Monocular/server.cc).

Port of swarmmap_tpu/cli/swarm_server.py: the dispatch service +
per-client mediators + the STS scheduler over websockets
(`net/wsrpc.py`), with the server's device programs on the card by
default.

    python -m swarmmap_tpu_torch.cli.swarm_server -d config/mh123.yaml
    python -m swarmmap_tpu_torch.cli.swarm_server --port 2327
"""
from __future__ import annotations

import signal
import time
from pathlib import Path

import torch

from ..net.server_service import DispatchService, ServerService
from ..server.map_manager import MapManager
from ..server.mediator import AgentMediator
from ..server.scheduler import MediatorScheduler
from ..utils.config import DatasetConfig
from ..utils.device import default_device
from ..utils.logging import get_logger
from .common import apply_wire, base_parser, device_of, load_vocab

_log = get_logger("swarm_server")


class Server:
    def __init__(self, host: str, port: int, vocab, n_kp: int = 1024,
                 data_port_base: int | None = None,
                 device: torch.device | str | None = None):
        """`device` runs the mediators' and the scheduler's device
        programs; by default the card (`utils.device.default_device`)."""
        self.device = torch.device(default_device() if device is None else device)
        self.vocab = vocab
        self.n_kp = n_kp
        AgentMediator.registry.clear()
        self.map_manager = MapManager(device=self.device)
        # standalone server: free-running worker + detached-thread GBA,
        # like the reference (LoopClosing.cc:602)
        self.scheduler = MediatorScheduler(
            self.map_manager, distribute_fn=self._distribute,
            background_gba=True, device=self.device,
        )
        self.services: dict[int, ServerService] = {}
        self.data_port_base = data_port_base
        self.dispatch = DispatchService(host, port, self._make_mediator)

    def _make_mediator(self, agent_id: int) -> ServerService:
        med = AgentMediator(agent_id, self.vocab, self.map_manager, n_kp=self.n_kp,
                            device=self.device)
        self.scheduler.register_mediator(med)
        port = (self.data_port_base + agent_id) if self.data_port_base else None
        svc = ServerService(agent_id, self.scheduler, port=port)
        svc.start()
        self.services[agent_id] = svc
        return svc

    def _distribute(self, agent_id: int, payload: bytes):
        svc = self.services.get(agent_id)
        if svc is not None:
            svc.distribute_map(payload)

    def start(self):
        self.dispatch.start()
        self.scheduler.start_worker()

    def stop(self):
        self.scheduler.stop()
        self.dispatch.stop()
        for svc in self.services.values():
            svc.stop()

    def save_maps(self, out_dir):
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for mid, med in AgentMediator.registry.items():
            med.save_map(out / f"map-server-{mid}.bin")
        self.map_manager.save_global_trajectories(out)


def main(argv=None):
    p = base_parser("swarmmap edge server (PyTorch)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0, help="dispatch port")
    p.add_argument("--runtime", type=float, default=0.0,
                   help="seconds to run (0 = until SIGINT)")
    args = p.parse_args(argv)
    apply_wire(args)
    device = device_of(args)
    port = args.port
    if not port and args.dataset:
        port = DatasetConfig.load(args.dataset).port
    port = port or 2327
    server = Server(args.host, port, load_vocab(args.voc), device=device)
    server.start()
    _log.info("dispatch listening on %s:%d", args.host, port)
    try:
        if args.runtime > 0:
            time.sleep(args.runtime)
        else:
            signal.pause()
    except KeyboardInterrupt:
        pass
    server.save_maps(args.out)
    server.stop()
    return server


if __name__ == "__main__":
    main()
