"""Dense decoder LM in PyTorch."""
