"""PyTorch/CUDA port of the multi-tenant virtual-GPU risk-analysis system.

Same sub-package and module names as the JAX package ``repro`` beside it, so
each counterpart is easy to find.  Entry points run on a CUDA device unless
the caller names the CPU.
"""
