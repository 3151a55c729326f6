"""Hand-written CUDA kernels (``csrc/``) behind device-dispatching
wrappers, with their plain PyTorch versions in ``ref.py``."""
