"""The plain reference of each configuration (``frozen/``: a frozen copy
of the port's nets and pipeline in plain PyTorch and NumPy) and the
comparisons that decide a run's ``correct``."""
