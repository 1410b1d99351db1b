"""Hand-written CUDA kernels (sm_90a) and their plain PyTorch versions.

Each wrapper dispatches on the device of its input: a CUDA tensor launches
the kernel (or the wrapper raises), a CPU tensor takes the plain version.
Each kernel wrapper counts its launches in ``<wrapper>.launches`` (the two
stencil wrappers count their periodic launches, K7a's and K7b's, apart in
``<wrapper>.periodic_launches``, and the kernels with a bfloat16
instantiation their bf16 launches in ``<wrapper>.bf16_launches``) and each
plain version its calls in ``<plain>.calls``; ``counts`` reads and resets
them all.
"""
