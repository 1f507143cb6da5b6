"""PyTorch/CUDA port of the walk-these-ways simulator and policy stack.

A second package beside the JAX one, with the same sub-layout and the same
module and function names.  It imports torch and numpy only.  Entry points
take an explicit ``device`` that defaults to ``"cuda"``; the CPU is used
only when a caller asks for it (the parity tests do).
"""
__version__ = "0.1.0"
