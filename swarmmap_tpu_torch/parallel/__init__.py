from .mesh import Mesh, agent_mesh, obs_mesh, shard_agents
