"""Kernels (FAN): the device ms a step in kernels other than the
convolutions, over the window's steps: BatchNorm's passes, the ReLUs, the
concatenations, adds and pooling, the AWing loss and Adam. A kernel is a
convolution's, forward or backward, where its name holds one of
``CONV_MARKS``, in any case: cuDNN's and CUTLASS's conv and GEMM kernels
by their names, every kernel in cuDNN's namespace or with its ``_cudnn``
suffix (layout changes and scaling around a conv), the filter flip of
its input gradient (``flip_filter``), and the complex-valued kernels of
its FFT convolutions (``pointwise_mult_and_sum_complex``, the ``float2``
transforms); the FAN step runs cuDNN for nothing else.
Memory copies and sets are no kernels."""

CONV_MARKS = ("fprop", "dgrad", "wgrad", "implicit_gemm",
              "implicit_convolve", "conv", "fft", "winograd", "gemm",
              "cudnn", "flip_filter", "complex", "float2")
NOT_KERNELS = ("memcpy", "memset")


def is_nonconv_kernel(name: str) -> bool:
    low = name.lower()
    return not any(low.startswith(m) for m in NOT_KERNELS) and not any(
        m in low for m in CONV_MARKS)


def read(run):
    trace, steps = run.get("trace"), run.get("steps")
    if trace is None or not steps:
        return None
    s = sum(t for n, t in trace["kernel_s"].items()
            if is_nonconv_kernel(n))
    if s <= 0:
        return None
    return 1e3 * s / steps
