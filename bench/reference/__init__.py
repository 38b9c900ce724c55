"""The plain reference: PyTorch in fp32, written from the architectures'
equations, independent of the program.  It imports torch alone: neither
``jax`` nor ``repro`` nor ``repro_torch``."""
