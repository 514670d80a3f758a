from chamjax_torch.data.datasets import (  # noqa: F401
    read_fvecs,
    read_bvecs,
    read_ivecs,
    write_fvecs,
    write_ivecs,
    read_fbin,
    read_ibin,
    write_fbin,
    mmap_fvecs,
    mmap_bvecs,
    load_dataset,
    load_real_dataset,
    synthetic_dataset,
    Dataset,
)
from chamjax_torch.data.ground_truth import compute_ground_truth  # noqa: F401
