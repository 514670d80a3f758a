from chamjax_torch.index.kmeans import (  # noqa: F401
    kmeans, assign as kmeans_assign, assign_balanced,
)
from chamjax_torch.index.pq import (  # noqa: F401
    train_pq, pq_encode, pq_decode, train_opq,
)
from chamjax_torch.index.ivf import PackedIVF, build_ivfpq  # noqa: F401
from chamjax_torch.index.device_build import (  # noqa: F401
    build_ivfpq_device,
    build_ivfpq_device_sharded,
    compute_ground_truth_streamed,
    lloyd_device,
)
