"""The mesh tier: list-sharded IVF-PQ search and tensor-parallel decode over
a mesh of positions placed explicitly (the port of ``chamjax/parallel``)."""

from chamjax_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_to,
    all_reduce_sum,
    make_mesh,
)
from chamjax_torch.parallel.sharded_search import (  # noqa: F401
    ShardedIVF,
    place_sharded,
    shard_index,
    sharded_search,
    sharded_search_2d,
)
from chamjax_torch.parallel.sharded_model import (  # noqa: F401
    shard_decoder_params,
    shard_kv_cache,
    shard_llama_params,
)
