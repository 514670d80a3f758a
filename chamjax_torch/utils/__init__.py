from chamjax_torch.utils.results import ResultStore  # noqa: F401
