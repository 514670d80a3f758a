from chamjax_torch.data.datasets import Dataset, synthetic_dataset  # noqa: F401
from chamjax_torch.data.ground_truth import compute_ground_truth  # noqa: F401
