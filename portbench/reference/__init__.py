"""The plain references that decide ``correct``: plain PyTorch and NumPy,
importing nothing of the program (``model.py``: the RALM transformers;
``search.py``: the IVF-PQ search)."""
