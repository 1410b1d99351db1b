"""Hand-written CUDA kernels (sm_90a) and their plain PyTorch versions.

Each wrapper dispatches on the device of its input: a CUDA tensor launches
the kernel (or the wrapper raises), a CPU tensor takes the plain version.
Each kernel wrapper counts its launches in ``<wrapper>.launches`` and each
plain version its calls in ``<plain>.calls``.
"""
