"""Standalone agent (reference: code/Examples/Monocular/client.cc).

Port of swarmmap_tpu/cli/swarm_client.py, on the card by default:
registers with the dispatch service, connects the data channel, then
tracks its sequence with the 500 ms state-report / 2 s map-push cadence
(client.cc:154-172).

    python -m swarmmap_tpu_torch.cli.swarm_client -d config/mh1.yaml --host 127.0.0.1
    python -m swarmmap_tpu_torch.cli.swarm_client --synthetic --agent 0
"""
from __future__ import annotations

import time
from pathlib import Path

from ..net.client_service import ClientService
from ..swarm import SwarmAgent
from ..utils.logging import get_logger
from .common import apply_wire, base_parser, device_of, load_vocab, load_world

_log = get_logger("swarm_client")


def main(argv=None):
    p = base_parser("swarmmap standalone agent (PyTorch)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2327, help="dispatch port")
    p.add_argument("--agent", type=int, default=0,
                   help="synthetic agent index / dataset sequence index")
    p.add_argument("--realtime", action="store_true",
                   help="pace frames at the camera fps")
    args = p.parse_args(argv)
    apply_wire(args)

    device = device_of(args)
    settings, seqs = load_world(args, args.agent + 1)
    seq = seqs[min(args.agent, len(seqs) - 1)]
    vocab = load_vocab(args.voc)
    agent = SwarmAgent(args.agent, settings, vocab, device=device)
    if args.load_map:
        agent.system.load_map(args.load_map)
    svc = ClientService(agent, args.host)
    new_id, data_port = svc.register(args.port)
    svc.connect(data_port)

    fps = settings.camera.fps
    report_every = max(int(0.5 * fps), 1)
    push_every = max(int(2 * fps), 1)
    t0 = time.time()
    for i in range(len(seq)):
        agent.track(seq.read(i), float(seq.timestamps[i]))
        if (i + 1) % report_every == 0:
            svc.report_state()
        if (i + 1) % push_every == 0:
            n = svc.push_map()
            if n:
                _log.info("frame %d: pushed %.1f KB", i, n / 1e3)
        if args.realtime:
            lag = (i + 1) / fps - (time.time() - t0)
            if lag > 0:
                time.sleep(lag)
    svc.push_map()
    time.sleep(1.0)  # let the final DistributeMap arrive
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    agent.system.save_keyframe_trajectory_tum(
        out / f"KeyFrameTrajectory-client-{agent.agent_id}.txt"
    )
    if args.save_map:
        # reference layout: map-client-<id>.bin (README.md:181-183)
        agent.system.save_map(args.save_map)
    _log.info("agent %d done: tracked %d/%d, kf=%d mp=%d",
              agent.agent_id, agent.frames_tracked, len(seq),
              agent.system.n_keyframes(), agent.system.n_map_points())
    svc.close()
    return agent


if __name__ == "__main__":
    main()
