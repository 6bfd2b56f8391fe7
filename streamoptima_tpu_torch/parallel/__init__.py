"""Multi-device encode and decode: GOP and row-tile sharding over a mesh."""
from streamoptima_tpu_torch.parallel.mesh import Mesh, ShardedCodec, make_mesh  # noqa: F401
