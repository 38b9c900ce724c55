"""Model configuration and the plain-PyTorch model stack."""
