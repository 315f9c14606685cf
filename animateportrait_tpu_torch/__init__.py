"""animateportrait_tpu_torch: the PyTorch/CUDA port of animateportrait_tpu.

One face photo + one speech WAV -> drawing-style talking-portrait frames,
on an NVIDIA H100 (sm_90a). The JAX package beside it is the reference the
port is tested against; this package imports torch and never jax, and
nothing of the JAX package: it keeps its own copy of the data files it
reads (canonical face, AutoVC normalization, target speaker embedding) in
``assets/``, loaded by ``utils.assets``. Its entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.

Subpackages mirror the JAX package: ``ops`` (numerics, with the kernel
wrappers ``ops.stft`` and ``ops.instnorm``), ``models``, ``pipeline``,
``io`` (JAX-variables -> state-dict converters) and ``utils``; ``csrc``
holds the CUDA sources and ``kernels`` builds and loads them;
``parallel`` and ``utils.distributed`` run the multi-card paths.
"""
