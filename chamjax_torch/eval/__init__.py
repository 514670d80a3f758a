from chamjax_torch.eval.recall import recall_at_k  # noqa: F401
from chamjax_torch.eval.ties import tie_mismatches  # noqa: F401
from chamjax_torch.eval.diagnose import recall_diagnosis  # noqa: F401
