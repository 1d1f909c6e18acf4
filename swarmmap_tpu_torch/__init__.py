"""swarmmap_tpu_torch — the PyTorch + CUDA port of swarmmap_tpu.

The JAX package (`swarmmap_tpu/`) is the reference; this package carries
the same functions, names and array layouts in PyTorch, with the agent
axis written out as a leading batch dimension instead of `jax.vmap`.
Hand-written Hopper kernels live under `csrc/` and are built at first use
by `_build.py`; every kernel has a plain PyTorch version beside it, which
a wrapper takes only for tensors that lie on the CPU.

Layer map (ported so far):
  core/     the single-agent client (system.py: monocular, RGB-D and
            stereo): the tracker (tracking.py), local mapping
            (local_mapping.py), dynamic-object filtering (dynamic.py: the
            vote ledger, LK mask propagation, the shipped segmenter as
            torch convolutions) and their host state: frames, the map
            store, the keyframe database
  ops/      device programs: pyramid, FAST, orientation, rBRIEF, matching,
            stereo depths, LM pose optimisation (CUDA kernel:
            csrc/pose_lm.cu), RANSAC PnP, two-view initialisation,
            triangulation, bundle adjustment (dense and CG), Sim3 RANSAC
            and refinement, the essential-graph optimiser; the BoW
            vocabulary
  pipeline  the fused per-frame tracking step, batched over agents, and
            its agent-sharded form over a device list
  parallel/ device lists as meshes (mesh.py: agent and observation
            meshes, shard-ordered collectives) and the multi-device dry
            run (dryrun.py)
  sync/     the change log with push / pull (oplog.py), the msgpack wire
            and map files (codec.py over msgpack_wire.py), the reference's
            boost text wire and binary map files
  server/   the edge server: per-client replicas (mediator.py), the STS
            scheduler, loop closing, map merge and joint group BA
  swarm     SwarmAgent: one client with its change log and sync endpoints;
            Swarm: N agents, their mediators and the scheduler in one
            process, the steady agents' frames as one batched dispatch
  cli/      the entry points (swarm_map, mono, swarm_server, swarm_client,
            relocalizer), on the card unless --device names another
  net/      the websocket transport (ws_wire.py: RFC 6455 on asyncio
            streams) and the client / server / dispatch services
  viz/      the HTML map viewer, the live view, matplotlib PNG maps
  bench     bench.py's tracking metrics for the port on the card
  native    host C++ (csrc/*.cc, g++ + ctypes): quadtree keypoint budgets,
            covisibility, keyframe redundancy, op-log compaction
  convert   numpy <-> tensor conversion of the JAX package's records, and
            its segmenter's weights into the port's module
  utils/    config (its own cv::FileStorage YAML reader), the EuRoC /
            TUM / KITTI loaders over png.py (a PNG codec on zlib), logging,
            padding, stats, timers, trajectory files, transfers,
            torch.profiler ranges, the synthetic world (with its moving
            flock and stereo pairs)
"""
import torch as _torch

__version__ = "0.1.0"

MAP_BASE = 1_000_000  # global id stride per map (reference: code/include/Map.h:45)

# Full fp32 everywhere.  The exactness arguments of the front end (integral
# pyramid levels, integer FAST differences, {-1,0,1} BRIEF weights) assume
# fp32 products; a blur or resize routed through cuDNN/cuBLAS in TF32 keeps
# ~3 decimal digits and would move pixels across the rounding boundary.
# Mirrors swarmmap_tpu/__init__.py's "highest" matmul precision pin.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
