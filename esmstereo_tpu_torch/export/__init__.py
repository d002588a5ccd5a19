"""Export of the eval model for native serving: a ``torch.export`` program
and its AOTInductor package (``program.py``)."""
