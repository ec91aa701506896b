from super_resolution_tpu.parallel.mesh import (  # noqa: F401
    BAND_AXIS,
    COL_AXIS,
    FRAME_AXIS,
    ROW_AXIS,
    make_mesh,
    named_sharding,
)
from super_resolution_tpu.parallel.data_parallel import (  # noqa: F401
    band_split_minimize,
    make_sharded_map_solver,
    shard_problem,
)
