from chamjax_torch.eval.recall import recall_at_k  # noqa: F401
