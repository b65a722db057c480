from .mesh import RenderMesh, shard_ray_state
from .world_shard import ShardedRenderer, ShardedWorld
