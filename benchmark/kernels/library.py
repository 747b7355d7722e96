"""cuDNN's and cuBLAS's kernels (the strided and grouped convs, the
linear layers, a library's GEMMs): timed by name, no work of their own
counted here."""
PRIORITY = 90
PATTERNS = [r"cudnn", r"xmma", r"implicit_gemm", r"implicit_convolve",
            r"cutlass", r"gemm", r"nvjet", r"cublas", r"sm90_", r"sm80_",
            r"wgrad_alg", r"dgrad_engine", r"dgrad2d", r"conv2d_grouped",
            r"convolve_", r"fft2d", r"winograd", r"splitKreduce"]
