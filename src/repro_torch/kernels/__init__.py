"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref.py``) and the model-aware dispatch (``ops.py``).  Sources live in
``csrc/``; ``build.py`` compiles them with nvcc at first use."""
