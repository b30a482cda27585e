"""Entry points of the PyTorch package (``python -m repro_torch.launch.serve``)."""
