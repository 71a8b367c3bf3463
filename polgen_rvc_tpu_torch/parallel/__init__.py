from .mesh import Mesh, make_mesh, replicate, shard_batch, shard_hubert_params
