from .hosts import convert_batch_across_hosts, host_share, host_sum, init_hosts
from .mesh import Mesh, make_mesh, replicate, shard_batch
