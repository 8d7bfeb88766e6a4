from .mesh import (
    Mesh,
    make_mesh,
    mesh_for,
    data_sharding,
    replicated,
    sharded_map_frames,
    init_distributed,
)
from .sharded_ba import sharded_bundle_adjust
