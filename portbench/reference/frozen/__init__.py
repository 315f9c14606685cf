"""A frozen copy of the port's modules that the benchmark's
configurations run (``animateportrait_tpu_torch`` as of the benchmark's
first version), the plain reference that decides ``correct``.

The files keep the port's layout and code; imports point here, and the
two kernel entry points are plain PyTorch: ``ops/instnorm.py`` is
``F.instance_norm`` (kernel K2, and autograd for K2b) and
``ops/spectral.py:mel_spectrogram`` takes the framed-DFT STFT (kernel
K1). Nothing here imports the port, JAX or the JAX package, and no later
change to the port reaches this copy: it is the yardstick the port's
timed path is held to.
"""
