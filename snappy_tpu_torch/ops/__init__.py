"""Block decode: the plain torch version, the CUDA kernel and its build, and
the raw-stream host driver."""
