"""The LM zoo on PyTorch: the SSM family (Mamba2)."""
